"""``dryrun_multichip``: one full MapCMA IL step over a ``(data, model)``
mesh, then the fused mapper + policy act over it; the port's counterpart
of ``__graft_entry__.py::dryrun_multichip``.

    python -m ivlnce_tpu_torch.parallel.dryrun 4      # 4 visible cards
    python -m ivlnce_tpu_torch.parallel.dryrun 8 --device cpu

The mesh takes ``model_parallel = 2`` when ``n`` is even and at least 4.
The step (depth and maps 64^2, 16 tokens, T = 3, N = 2 lanes per data
row, hidden 512, the progress monitor, Adam at 2.5e-4, inputs drawn from
``numpy.random.default_rng(0)``) runs on ``shard_policy``'s copy through
``sharded_train_step``; its loss must equal a one-device step's from the
same weights within 1e-4 * max(1, |loss|). The fused act runs the mapper
(K1, K2: grid 256, window 96) on each data row's lanes on that row's
lead, and each row's copy of the stepped policy acts deterministically on
the maps."""

from __future__ import annotations

import argparse
import copy
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ivlnce_tpu_torch.models.il_update import train_mode, train_step
from ivlnce_tpu_torch.parallel.mesh import (
    Mesh,
    lane_shards,
    local_devices,
    make_mesh,
)
from ivlnce_tpu_torch.parallel.tensor import shard_policy
from ivlnce_tpu_torch.parallel.train import sharded_train_step

DEPTH_HW, MAP_HW, TOKENS, T = 64, 64, 16, 3
LR = 2.5e-4
LOSS_RTOL = 1e-4


def make_policy():
    """The default config's MapCMA policy (hidden 512) with the progress
    monitor, weights from seed 0, on the CPU."""
    from ivlnce_tpu_torch.config import get_config
    from ivlnce_tpu_torch.models.policy import MapCMAPolicy

    config = get_config(None, ["MODEL.policy_name", "MapCMAPolicy",
                               "MODEL.PROGRESS_MONITOR.use", True])
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return MapCMAPolicy.from_config(
            config, {"depth_hw": DEPTH_HW, "map_hw": MAP_HW})


def example_obs(n: int, depth_hw: int, map_hw: int, tokens: int, rng):
    """``__graft_entry__._example_obs``: half the tokens drawn, half
    padding; depth in [0, 1); random maps."""
    return {
        "instruction": np.concatenate(
            [rng.integers(1, 2000, size=(n, tokens // 2)),
             np.zeros((n, tokens - tokens // 2), np.int64)], axis=1,
        ).astype(np.int64),
        "depth": rng.random((n, depth_hw, depth_hw, 1)).astype(np.float32),
        "occupancy_map": rng.integers(
            0, 3, size=(n, map_hw, map_hw)).astype(np.uint8),
        "semantic_map": rng.integers(
            0, 14, size=(n, map_hw, map_hw)).astype(np.uint8),
    }


def mapper_params():
    from ivlnce_tpu_torch.mapping import camera as cam
    from ivlnce_tpu_torch.mapping.mapper import MapperParams

    return MapperParams(
        camera=cam.CameraParameters(
            vertical_fov_radians=cam.vertical_fov_radians(
                90.0, DEPTH_HW, DEPTH_HW),
            features_spatial_dimensions=(DEPTH_HW, DEPTH_HW),
            height_clip=0.1,
        ),
        map_height_meters=6.4,
        map_width_meters=6.4,
        resolution_meters=0.1,
        grid_cells=256,
        window_cells=96,
    )


def fused_act(mesh: Mesh, copies: Dict[tuple, torch.nn.Module],
              inputs: Dict[str, np.ndarray]):
    """One mapper step and one deterministic act for each data row's lanes
    on its lead, through ``copies[row]``. Returns (actions (N, 1), logits
    (N, A)) on the mesh's lead."""
    from ivlnce_tpu_torch.mapping import mapper as M

    params = mapper_params()
    n = len(inputs["pose"])
    actions, logits = [], []
    for row, (device, lanes) in zip(mesh.grid, lane_shards(mesh, n)):
        policy = copies[row]
        b = lanes.stop - lanes.start

        def dev(key):
            return torch.from_numpy(inputs[key][lanes]).to(device)

        state = M.init_state(b, params.grid_cells, device)
        zeros = inputs["zeros"][lanes]
        _, occ, sem = M.mapper_step(
            params, state, dev("depth_frames"), dev("sem_frames"),
            inputs["pose"][lanes], zeros, zeros, inputs["ones"][lanes])
        obs = {"instruction": dev("instruction"), "depth": dev("depth"),
               "occupancy_map": occ, "semantic_map": sem}
        with torch.no_grad():
            out = policy.act(
                obs, policy.initial_rnn_states(b, device),
                torch.zeros((b, 1), dtype=torch.int64, device=device),
                torch.ones((b, 1), device=device))
        actions.append(out.actions.to(mesh.lead))
        logits.append(out.logits.to(mesh.lead))
    return torch.cat(actions), torch.cat(logits)


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None
                     ) -> dict:
    """The step and the fused act over the first ``n_devices`` of
    ``devices`` (default: the visible cards). Raises if the sharded loss
    differs from the one-device loss. Returns the mesh shape, the loss
    terms and the one-device loss, the shapes, the fused act's actions and
    logits and its inputs, the mesh, each data row's copy of the stepped
    policy (``copies``) and the step."""
    devices = list(local_devices("cuda") if devices is None else devices)
    if len(devices) < n_devices:
        raise ValueError(f"need {n_devices} devices, have {len(devices)}")
    model_parallel = 2 if (n_devices % 2 == 0 and n_devices >= 4) else 1
    mesh = make_mesh(n_devices, model_parallel=model_parallel,
                     devices=devices)
    lead = mesh.lead
    n = 2 * mesh.shape["data"]  # lanes shard over the data axis
    rng = np.random.default_rng(0)
    obs = example_obs(T * n, DEPTH_HW, MAP_HW, TOKENS, rng)
    obs["progress"] = rng.random((T * n, 1)).astype(np.float32)
    prev_actions = rng.integers(0, 4, size=(T * n, 1)).astype(np.int64)
    episode_masks = (rng.random((T, n)) > 0.2).astype(np.float32)
    tour_masks = np.ones((T, n), np.float32)
    corrected = rng.integers(0, 4, size=(T, n)).astype(np.int64)
    weights = rng.random((T, n)).astype(np.float32) + 0.5
    batch = [obs, prev_actions, episode_masks, tour_masks, corrected,
             weights]

    base = make_policy()
    policy = train_mode(shard_policy(base, mesh))
    step = sharded_train_step(mesh)
    loss, action_loss, aux_loss, rnn_out = step(
        policy, torch.optim.Adam(policy.parameters(), lr=LR), *batch,
        base.initial_rnn_states(n, lead), True, 1.0, False)

    # loss parity: the same step on one device, from the same weights
    # (catches silently wrong shardings)
    one = train_mode(copy.deepcopy(base).to(lead))
    loss1 = train_step(
        one, torch.optim.Adam(one.parameters(), lr=LR), *batch,
        one.initial_rnn_states(n, lead), True, 1.0, False)[0]
    loss, loss1 = float(loss), float(loss1)
    if abs(loss - loss1) > LOSS_RTOL * max(1.0, abs(loss1)):
        raise AssertionError(f"sharded loss {loss:.6f} != single-device "
                             f"{loss1:.6f}")

    # the fused mapper + policy act over the data axis, params sharded
    inputs = {k: obs[k][:n] for k in ("instruction", "depth")}
    inputs["depth_frames"] = (rng.random((n, DEPTH_HW, DEPTH_HW)).astype(
        np.float32) * 0.5 + 0.05)
    inputs["sem_frames"] = rng.integers(
        0, 14, size=(n, DEPTH_HW, DEPTH_HW)).astype(np.uint8)
    inputs["pose"] = rng.normal(size=(n, 3)).astype(np.float32)
    inputs["zeros"] = np.zeros((n,), np.float32)
    inputs["ones"] = np.ones((n,), np.float32)
    copies = {row: step.replicas.get(row, policy) for row in mesh.grid}
    actions, logits = fused_act(mesh, copies, inputs)
    if tuple(actions.shape) != (n, 1):
        raise AssertionError(f"act_actions {tuple(actions.shape)}")
    out = {
        "mesh": mesh.shape, "loss": loss, "single_device_loss": loss1,
        "action_loss": float(action_loss), "aux_loss": float(aux_loss),
        "rnn_out": tuple(rnn_out.shape), "act_actions": tuple(actions.shape),
        "actions": actions, "logits": logits, "inputs": inputs,
        "mesh_obj": mesh, "copies": copies, "step": step,
    }
    print(f"dryrun_multichip ok: mesh={out['mesh']} loss={loss:.4f} "
          f"(single-device parity {loss1:.4f}) "
          f"action={out['action_loss']:.4f} aux={out['aux_loss']:.4f} "
          f"rnn_out={out['rnn_out']} act_actions={out['act_actions']}")
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("n_devices", type=int)
    parser.add_argument("--device", default="cuda",
                        help="cuda: the visible cards; cpu: the CPU listed "
                             "n_devices times")
    args = parser.parse_args(argv)
    devices = None if args.device == "cuda" else [args.device] * \
        args.n_devices
    dryrun_multichip(args.n_devices, devices)


if __name__ == "__main__":
    main()
