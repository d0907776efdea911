"""The plain reference of a tour eval, lane by lane: it follows a sample of
lanes through every step of a run from the run's frames, schedule and
weights, and judges what the program produced there.

The encoders are not recurrent, so each of a lane's pool frames is
encoded once; the mapper and the recurrent step run step by step. The
program's actions are read as the previous actions of the next step (as
a served model's tokens are read), and each one is judged by how far its
logit lies below the reference's best."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench.reference import policy as P
from portbench.reference.mapper import RefMapper

BLOCK = 256  # frames per encoder call


def _blocks(fn, x: torch.Tensor) -> torch.Tensor:
    return torch.cat([fn(x[i:i + BLOCK]) for i in range(0, len(x), BLOCK)])


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def _episodes(schedule, lanes: np.ndarray, steps: int) -> np.ndarray:
    """(steps, S) episode index of each sample lane at each step."""
    s = np.arange(steps)
    return np.stack([np.searchsorted(schedule.starts[i], s, side="right") - 1
                     for i in lanes], 1)


@torch.no_grad()
def follow(kind: str, widths: Dict, model: Dict, weights: Dict,
           sample: np.ndarray, steps: int, schedule, frames: int,
           pool: Dict, pose: Dict, actions: np.ndarray, kept: Dict,
           device) -> Dict:
    from portbench.inputs.tours import frame_index

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w = {k: v.to(device) for k, v in weights.items()}
    n = len(sample)

    # encoders over the sample lanes' pool frames: (P, S, ...)
    depth = torch.from_numpy(
        pool["depth"][:, sample][..., 0].astype(np.int32)).to(device)
    depth = depth.reshape((-1,) + depth.shape[2:])
    dfeat = _blocks(lambda d: P.depth_encoder(w, d.float() * (1.0 / 65535.0)),
                    depth)
    dfeat = dfeat.reshape((frames, n) + dfeat.shape[1:])
    if kind == "latent":
        rgb = torch.from_numpy(pool["rgb"][:, sample]).to(device)
        rgb = rgb.reshape((-1,) + rgb.shape[2:])
        ofeat = _blocks(lambda r: P.rgb_encoder(w, r), rgb)
        ofeat = ofeat.reshape((frames, n) + ofeat.shape[1:])
        del rgb
    del depth

    # instruction features of each sample lane's episodes
    ep = _episodes(schedule, sample, steps)
    pairs = sorted({(int(sample[j]), int(e)) for j in range(n)
                    for e in np.unique(ep[:, j])})
    index = {p: i for i, p in enumerate(pairs)}
    tokens = torch.from_numpy(np.stack([schedule.instruction(*p)
                                        for p in pairs])).to(device)
    txt = P.instruction_encoder(w, tokens)

    # the mapper, step by step, and the map features
    maps = None
    if kind == "map":
        mapper = RefMapper(n, widths["world_grid_cells"],
                           (widths["depth_side"], widths["depth_side"]),
                           widths["hfov"], widths["map_meters"],
                           widths["map_resolution"], widths["window_cells"],
                           device)
        occ_all, sem_all = [], []
        for s in range(steps):
            f = frame_index(s, frames)
            m = schedule.masks(s)
            keep = ~m.tour_start[sample]
            d = torch.from_numpy(
                pool["depth"][f][sample][..., 0].astype(np.int32)).to(device)
            lab = torch.from_numpy(pool["semantic12"][f][sample][..., 0]).to(
                device)
            occ, sem = mapper.step(d, lab, pose["world_robot_pose"][f, sample],
                                   pose["world_robot_orientation"][f, sample],
                                   keep)
            occ_all.append(occ)
            sem_all.append(sem)
        del mapper
        occ_all = torch.stack(occ_all)
        sem_all = torch.stack(sem_all)
        side = occ_all.shape[-1]
        mfeat = _blocks(
            lambda x: P.map_encoder(w, x[:, 0], x[:, 1]),
            torch.stack([occ_all, sem_all], 2).reshape(-1, 2, side, side),
        )
        mfeat = mfeat.reshape((steps, n) + mfeat.shape[1:])
        maps = (occ_all, sem_all)

    # the recurrent steps
    layers = 3 if model.get("tour_memory_variant") else 2
    hidden = widths["hidden_size"]
    rnn = torch.zeros((n, layers, hidden), device=device)
    ref_kept = {}
    prog = torch.from_numpy(actions[:, sample].astype(np.int64)).to(device)
    limit_rows = []
    for s in range(steps):
        m = schedule.masks(s)
        f = frame_index(s, frames)
        start = torch.from_numpy(m.episode_start[sample]).to(device)
        tour = torch.from_numpy(~m.tour_start[sample]).to(device).float()
        agent = (~start).float()
        prev = prog[s - 1] if s > 0 else torch.zeros_like(prog[0])
        prev = torch.where(start, torch.zeros_like(prev), prev)
        idx = ((prev + 1).float() * agent).long()
        vis = {"depth": dfeat[f]}
        if kind == "map":
            vis["map"] = mfeat[s]
        else:
            vis["rgb"] = ofeat[f]
        t = txt[[index[(int(sample[j]), int(ep[s, j]))] for j in range(n)]]
        feats = P.visual_features(w, kind, vis)
        out, rnn = P.cma_step(
            w, kind, feats, t, idx, rnn, agent,
            tour if kind == "latent" else None,
            memory_variant=bool(model.get("tour_memory_variant")),
            memory_at_end=bool(model.get("memory_at_end")))
        logits = P.action_logits(w, out)
        g = logits.max(1).values - logits.gather(1, prog[s][:, None])[:, 0]
        limit_rows.append(g)
        if s in kept:
            ref_kept[s] = {"logits": logits.cpu(), "rnn": rnn.cpu()}
            if maps is not None:
                ref_kept[s]["occupancy"] = maps[0][s].cpu()
                ref_kept[s]["semantic"] = maps[1][s].cpu()
    gaps = torch.stack(limit_rows)

    logit_err = rnn_err = 0.0
    cells = 0
    for s, got in kept.items():
        want = ref_kept[s]
        logit_err = max(logit_err, _gap(got["logits"], want["logits"]))
        rnn_err = max(rnn_err, _gap(got["rnn"], want["rnn"]))
        if "occupancy" in got:
            cells += int(((got["occupancy"] != want["occupancy"])
                          | (got["semantic"] != want["semantic"])).sum())
    return {"action_gap": float(gaps.max()), "gaps": gaps.cpu(),
            "logit_err": logit_err, "rnn_err": rnn_err,
            "map_cells_off": float(cells)}
