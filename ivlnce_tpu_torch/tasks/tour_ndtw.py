"""Tour-nDTW: the split-level iterative-evaluation metric.

Reference: habitat_extensions/tour_ndtw.py. Per tour, a constrained DTW
between the agent's and GT "agent-phase" positions, with episode-boundary
alignment points forced via a window; exp(-d / (len(gt) * 3m)); aggregated
across tours weighted by episode count.

Reference quirks replicated deliberately (metric parity):
- ``novel_only`` dedup is applied to the agent path, but the GT path
  dedup result is immediately overwritten (tour_ndtw.py:110-112) — the GT
  path keeps consecutive duplicates;
- episodes_per_tour counts episode TRANSITIONS (tour_ndtw.py:8-16), i.e.
  (num_episodes - 1) per tour.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

import numpy as np

from ivlnce_tpu_torch.tasks.dtw import windowed_dtw


def _windowed_dtw_dispatch(ap, gtp, alignments) -> float:
    """Native C++ windowed DTW when available
    (ivlnce_tpu_torch/native/dtw.cpp), else the vectorized numpy kernel."""
    from ivlnce_tpu_torch import native

    lib = native.dtw_library()
    if lib is not None:
        x = np.ascontiguousarray(ap, np.float64)
        y = np.ascontiguousarray(gtp, np.float64)
        aligns = np.ascontiguousarray(alignments, np.int64)
        return float(
            lib.dtw_windowed(
                x, len(x), y, len(y),
                aligns.ctypes.data if len(aligns) else None,
                len(aligns),
            )
        )
    window = window_from_alignments(len(ap), len(gtp), alignments)
    return windowed_dtw(ap, gtp, window)


def compute_episodes_per_tour(tours: Dict[str, List]) -> Dict[str, int]:
    eps_per_tour = defaultdict(int)
    for tour_id, path in tours.items():
        for i in range(1, len(path)):
            if path[i]["episode_id"] != path[i - 1]["episode_id"]:
                eps_per_tour[tour_id] += 1
    return eps_per_tour


def window_from_alignments(
    query_size: int, reference_size: int, alignments
) -> np.ndarray:
    """For each alignment (i, j): column j admits only row i
    (tour_ndtw.py:19-27)."""
    window = np.ones((query_size, reference_size), dtype=bool)
    for (i, j) in alignments:
        window[:, j] = False
        window[i, j] = True
    return window


def extract_ep_order(path) -> List[str]:
    eps = [p["episode_id"] for p in path]
    eps_single = []
    for i in range(1, len(eps)):
        if eps[i - 1] != eps[i]:
            eps_single.append(eps[i - 1])
    eps_single.append(eps[-1])
    return eps_single


def alignments_from_paths(agent_path, gt_path):
    gt_path = [p for p in gt_path if p["phase"] == "agent"]
    agent_path = [p for p in agent_path if p["phase"] == "agent"]

    assert extract_ep_order(gt_path) == extract_ep_order(
        agent_path
    ), "agent and GT episode orders do not match."

    def boundary_points(path):
        pts = []
        for i in range(1, len(path)):
            if path[i]["episode_id"] != path[i - 1]["episode_id"]:
                pts.append(i - 1)  # stopping point
                pts.append(i)  # starting point
        return pts

    agent_pts = boundary_points(agent_path)
    gt_pts = boundary_points(gt_path)
    assert len(agent_pts) == len(
        gt_pts
    ), "mismatch in number of alignment points."
    return list(zip(agent_pts, gt_pts))


def novel_only(path):
    """Drop consecutive duplicate entries (tour_ndtw.py:69-81)."""
    if len(path) <= 1:
        return path
    new_path = [path[0]]
    for i in range(1, len(path)):
        if path[i - 1] != path[i]:
            new_path.append(path[i])
    return new_path


def aggregate_scores(t_ndtws, episodes_per_tour) -> float:
    total_eps = sum(episodes_per_tour.values())
    score = 0.0
    for tour_id, tndtw in t_ndtws.items():
        score += tndtw * (episodes_per_tour[tour_id] / total_eps)
    return score


def compute_tour_ndtw(
    agent_paths: Dict[str, List],
    gt_paths: Dict[str, List],
    success_distance: float = 3.0,
    verbose: bool = False,
) -> float:
    if set(gt_paths.keys()) != set(agent_paths.keys()):
        raise ValueError("tours are different")

    t_ndtws = {}
    for tour_id, agent_path in agent_paths.items():
        agent_path = novel_only(agent_path)
        # reference quirk: GT novel_only is computed then discarded
        gt_path = gt_paths[tour_id]

        alignments = alignments_from_paths(agent_path, gt_path)

        ap = [p["position"] for p in agent_path if p["phase"] == "agent"]
        gtp = [p["position"] for p in gt_path if p["phase"] == "agent"]
        dtw_dist = _windowed_dtw_dispatch(ap, gtp, alignments)
        t_ndtws[tour_id] = float(
            np.exp(-dtw_dist / (len(gtp) * success_distance))
        )
        if verbose:
            print(round(t_ndtws[tour_id], 4), "\t", len(gtp))

    episodes_per_tour = compute_episodes_per_tour(gt_paths)
    return aggregate_scores(t_ndtws, episodes_per_tour)
