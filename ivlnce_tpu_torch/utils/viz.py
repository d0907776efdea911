"""Frame composition and video generation for eval.

Reference: habitat_extensions/utils.py (observations_to_image,
generate_video) and
ivlnce_baselines/common/mapping_module/visualize_semantic_map.py
(ego map rendering + frame stacking). Host-side only.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

try:
    import cv2
except ImportError:
    cv2 = None

from ivlnce_tpu_torch.tasks import maps as maps_util
from ivlnce_tpu_torch.utils import logging_util

logger = logging_util.logger

# 13-class semantic palette + void (visualize_semantic_map.py:12-26 keeps
# a class color table; values are our own)
SEMANTIC_MAP_COLORS = np.array(
    [
        [255, 255, 255],  # 0 void / floor
        [128, 128, 0],  # 1 chair
        [0, 128, 128],  # 2 table
        [128, 0, 128],  # 3 picture
        [0, 0, 160],  # 4 cabinet
        [160, 80, 0],  # 5 cushion
        [0, 160, 0],  # 6 sofa
        [160, 0, 0],  # 7 bed
        [80, 80, 160],  # 8 chest of drawers
        [160, 160, 0],  # 9 plant
        [0, 160, 160],  # 10 sink
        [160, 0, 160],  # 11 toilet
        [80, 160, 80],  # 12 stool
        [200, 120, 40],  # 13 towel
    ],
    np.uint8,
)


def colorize_depth(depth: np.ndarray) -> np.ndarray:
    """(H, W[, 1]) normalized depth -> 3-channel grayscale."""
    if depth.ndim == 3:
        depth = depth[..., 0]
    d = np.clip(depth, 0.0, 1.0)
    img = (d * 255.0).astype(np.uint8)
    return np.stack([img] * 3, axis=-1)


def visualize_ego_occupancy_map(occupancy: np.ndarray, scale: int = 4):
    """(R, C) uint8 occupancy -> upscaled RGB with an agent sprite at the
    center-bottom (visualize_semantic_map.py:101-106)."""
    occ = np.asarray(occupancy)
    img = np.where(occ[..., None] > 0, 60, 230).astype(np.uint8)
    img = np.repeat(img, 3, axis=-1)
    img = _upscale(img, scale)
    _draw_agent_sprite(img)
    return img


def visualize_ego_semantic_map(semantic: np.ndarray, scale: int = 4):
    sem = np.asarray(semantic).astype(np.int64) % len(SEMANTIC_MAP_COLORS)
    img = SEMANTIC_MAP_COLORS[sem]
    img = _upscale(img, scale)
    _draw_agent_sprite(img)
    return img


def _upscale(img: np.ndarray, scale: int) -> np.ndarray:
    return np.repeat(np.repeat(img, scale, axis=0), scale, axis=1)


def _draw_agent_sprite(img: np.ndarray) -> None:
    if cv2 is None:
        return
    h, w = img.shape[:2]
    maps_util.draw_triangle(
        img, (h // 2, w // 2), 0.0, (200, 100, 0), radius=max(4, h // 24)
    )


def append_image_horizontally(images: List[np.ndarray]) -> np.ndarray:
    """Pad to common height, concat on width
    (visualize_semantic_map.py:128-133)."""
    max_h = max(im.shape[0] for im in images)
    padded = []
    for im in images:
        pad = max_h - im.shape[0]
        padded.append(
            np.pad(im, ((0, pad), (0, 0), (0, 0)), constant_values=255)
        )
    return np.concatenate(padded, axis=1)


def append_image_vertically(images: List[np.ndarray]) -> np.ndarray:
    max_w = max(im.shape[1] for im in images)
    padded = []
    for im in images:
        pad = max_w - im.shape[1]
        padded.append(
            np.pad(im, ((0, 0), (0, pad), (0, 0)), constant_values=255)
        )
    return np.concatenate(padded, axis=0)


def append_text_to_image(image: np.ndarray, text: str) -> np.ndarray:
    """Render instruction text underneath the frame (habitat
    utils.append_text_to_image equivalent)."""
    if cv2 is None or not text:
        return image
    h, w = image.shape[:2]
    font, scale, thick = cv2.FONT_HERSHEY_SIMPLEX, 0.4, 1
    words = text.split()
    lines, cur = [], ""
    for word in words:
        trial = (cur + " " + word).strip()
        if cv2.getTextSize(trial, font, scale, thick)[0][0] > w - 10:
            lines.append(cur)
            cur = word
        else:
            cur = trial
    if cur:
        lines.append(cur)
    line_h = 14
    banner = np.full((line_h * len(lines) + 8, w, 3), 255, np.uint8)
    for i, line in enumerate(lines):
        cv2.putText(
            banner, line, (5, (i + 1) * line_h), font, scale, (0, 0, 0),
            thick, cv2.LINE_AA,
        )
    return np.concatenate([image, banner], axis=0)


def observations_to_image(observation: Dict, info: Dict) -> np.ndarray:
    """Compose rgb + depth + topdown map into one frame
    (habitat_extensions/utils.py:19-100)."""
    egocentric_view = []
    if "rgb" in observation:
        rgb = np.asarray(observation["rgb"])
        if rgb.dtype != np.uint8:
            rgb = (np.clip(rgb, 0, 255)).astype(np.uint8)
        egocentric_view.append(rgb)
    if "depth" in observation:
        egocentric_view.append(colorize_depth(np.asarray(observation["depth"])))
    assert egocentric_view, "expected at least one visual sensor"
    frame = append_image_horizontally(egocentric_view)

    map_info = info.get("top_down_map_vlnce") if info else None
    if map_info is not None:
        td = maps_util.colorize_topdown_map(
            map_info["map"], map_info.get("fog_of_war_mask")
        )
        if cv2 is not None:
            agent = map_info.get("agent_map_coord")
            if agent is not None:
                maps_util.draw_triangle(
                    td, agent, map_info.get("agent_angle", 0.0),
                    (200, 100, 0), radius=max(4, td.shape[0] // 40),
                )
            scale = frame.shape[0] / td.shape[0]
            td = cv2.resize(
                td,
                (int(td.shape[1] * scale), frame.shape[0]),
                interpolation=cv2.INTER_NEAREST,
            )
        frame = append_image_horizontally([frame, td])
    return frame


def generate_video(
    video_option: List[str],
    video_dir: Optional[str],
    images: List[np.ndarray],
    episode_id: str,
    checkpoint_idx: int,
    metrics: Dict[str, float],
    tb_writer,
    fps: int = 10,
) -> None:
    """Write eval videos to disk and/or tensorboard with metric-stamped
    names (habitat_extensions/utils.py:103-143)."""
    if len(images) < 1:
        return
    metric_strs = [f"{k}={v:.2f}" for k, v in metrics.items()]
    video_name = (
        f"episode={episode_id}-ckpt={checkpoint_idx}-"
        + "-".join(metric_strs)
    )
    if "disk" in video_option:
        assert video_dir is not None
        os.makedirs(video_dir, exist_ok=True)
        path = os.path.join(video_dir, video_name + ".mp4")
        try:
            import imageio

            writer = imageio.get_writer(path, fps=fps)
            for im in images:
                writer.append_data(im)
            writer.close()
        except Exception:
            # mp4 codecs vary by image; animated GIF via PIL next
            try:
                from PIL import Image

                frames = [Image.fromarray(im) for im in images]
                frames[0].save(
                    os.path.join(video_dir, video_name + ".gif"),
                    save_all=True,
                    append_images=frames[1:],
                    duration=int(1000 / fps),
                    loop=0,
                )
            except Exception as e:
                logger.warning(f"video encode failed ({e}); saving npz")
                np.savez_compressed(
                    os.path.join(video_dir, video_name + ".npz"),
                    frames=np.stack(images),
                )
    if "tensorboard" in video_option:
        tb_writer.add_video_from_np_images(
            f"episode{episode_id}", checkpoint_idx, images, fps=fps
        )
