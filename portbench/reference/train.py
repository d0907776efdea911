"""The plain reference of the MapCMA IL update: the sequence forward over
a collated (T, N) batch with autograd, the inflection-weighted loss with
the progress monitor's term, Adam, then the map encoder's running
statistics recomputed with the updated weights.

It starts from the weights the benchmark made and follows the program's
first steps, each on its own batch, and returns what the comparison
reads: each step's loss terms, every leaf's first gradient, every leaf's
change after the steps, and the map statistics after them."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench.reference import policy as P

BUFFERS = ("running_mean", "running_var")


def _forward(w: Dict, batch, alpha: float, use_progress: bool):
    dev = w["net.state_q.weight"].device
    obs = batch.observations
    t, n = batch.corrected.shape
    tokens = torch.from_numpy(obs["instruction"]).to(dev)
    uniq, inverse = torch.unique(tokens, dim=0, return_inverse=True)
    txt = P.instruction_encoder(w, uniq)[inverse]  # (T*N, 2H, L)
    occ = torch.from_numpy(obs["occupancy_map"]).to(dev)
    sem = torch.from_numpy(obs["semantic_map"]).to(dev)
    vis = {"depth": torch.from_numpy(obs["depth_features"]).to(dev),
           "map": P.map_encoder(w, occ, sem, training=True)}
    feats = P.visual_features(w, "map", vis)
    masks = torch.from_numpy(batch.not_done_masks.reshape(t, n))
    masks = masks.to(dev).float()
    prev = torch.from_numpy(batch.prev_actions.reshape(t, n)).to(dev)
    idx = ((prev + 1).float() * masks).long()
    layers, hidden = 2, w["net.state_q.weight"].shape[1]
    rnn = torch.zeros((n, layers, hidden), device=dev)
    outs = []
    for i in range(t):
        rows = slice(i * n, (i + 1) * n)
        out, rnn = P.cma_step(w, "map", tuple(x[rows] for x in feats),
                              txt[rows], idx[i], rnn, masks[i])
        outs.append(out)
    features = torch.cat(outs)
    logits = P.action_logits(w, features)
    corrected = torch.from_numpy(batch.corrected).to(dev)
    weights = torch.from_numpy(batch.weights).to(dev)
    logp = torch.log_softmax(logits.reshape(t, n, -1), -1)
    ce = -logp.gather(-1, corrected[..., None])[..., 0]
    action = ((weights * ce).sum(0) / weights.sum(0)).mean()
    aux = torch.zeros((), device=dev)
    if use_progress:
        target = torch.from_numpy(obs["progress"]).to(dev).reshape(-1).float()
        err = (P.progress(w, features) - target) ** 2
        mask = (weights > 0).reshape(-1).float()
        aux = alpha * (err * mask).sum() / mask.sum()
    return action + aux, action, aux, (occ, sem)


def follow(weights: Dict[str, torch.Tensor], batches: List, lr: float,
           alpha: float, use_progress: bool, device,
           betas=(0.9, 0.999), eps: float = 1e-8, tf32: bool = False) -> Dict:
    """``len(batches)`` updates from ``weights``. ``tf32`` computes them in
    TF32 (the control)."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    w = {k: v.to(device).clone() for k, v in weights.items()}
    names = [k for k in w if not k.endswith(BUFFERS)]
    start = {k: w[k].clone() for k in names}
    m = {k: torch.zeros_like(w[k]) for k in names}
    v = {k: torch.zeros_like(w[k]) for k in names}
    losses, first_grad = [], {}
    for step, batch in enumerate(batches, 1):
        params = {k: w[k].detach().requires_grad_(True) for k in names}
        cur = {**w, **params}
        loss, action, aux, maps = _forward(cur, batch, alpha, use_progress)
        grads = torch.autograd.grad(loss, [params[k] for k in names],
                                    allow_unused=True)
        losses.append(tuple(float(x.detach()) for x in (loss, action, aux)))
        with torch.no_grad():
            for k, g in zip(names, grads):
                if g is None:
                    continue
                if step == 1:
                    first_grad[k] = float(g.double().norm())
                m[k] = betas[0] * m[k] + (1 - betas[0]) * g
                v[k] = betas[1] * v[k] + (1 - betas[1]) * g * g
                mh = m[k] / (1 - betas[0] ** step)
                vh = v[k] / (1 - betas[1] ** step)
                w[k] = w[k] - lr * mh / (vh.sqrt() + eps)
            w = {k: t.detach() for k, t in w.items()}
            w.update(P.map_running_stats(w, *maps))
        del params, cur, grads, loss
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    change = {k: float((w[k] - start[k]).double().norm()) for k in first_grad}
    stats = {k: w[k].cpu() for k in w if k.endswith(BUFFERS)
             and k.startswith("net.map_encoder.")}
    return {"losses": losses, "first_grad": first_grad, "change": change,
            "map_stats": stats}


def rounding_leaves(first_grad: Dict[str, float],
                    share: float = 1e-3) -> List[str]:
    """Leaves whose reference gradient is nought to rounding (under
    ``share`` of the median leaf's, as a bias ahead of a training-mode
    BatchNorm or under a softmax): Adam moves them by round-off alone."""
    med = float(np.median(list(first_grad.values())))
    return sorted(k for k, g in first_grad.items() if g < share * med)


def leaf_gaps(got: Dict[str, float], want: Dict[str, float],
              left_out: List[str]) -> Dict[str, float]:
    """Each leaf's |norm(program) - norm(reference)| over the larger of
    the reference's norm and the median leaf's, for the leaves not
    ``left_out``; a leaf that one side moves and the other does not
    reads 1."""
    med = float(np.median(list(want.values())))
    gaps = {}
    for k, ref in want.items():
        if k not in left_out:
            val = got.get(k)
            gaps[k] = 1.0 if val is None else abs(val - ref) / max(ref, med)
    for k in got:
        if k not in want and k not in left_out and got[k] > 0:
            gaps[k] = 1.0
    return gaps
