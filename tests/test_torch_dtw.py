"""t-nDTW's DTW in the port against the JAX package's, on seeded tours:
the port's native library (``ivlnce_tpu_torch/native/dtw.cpp``) equals
the JAX package's native one exactly, and with no library on either side
the two numpy DTWs are equal too."""

import numpy as np
import pytest

from ivlnce_tpu import native as jax_native
from ivlnce_tpu.tasks import tour_ndtw as jnd
from ivlnce_tpu_torch import native as torch_native
from ivlnce_tpu_torch.tasks import tour_ndtw as tnd


def _tour_paths(seed):
    """(agent paths, GT paths) of three seeded tours of 2-4 episodes:
    random walks, oracle-phase points between episodes, repeated agent
    positions (``novel_only`` drops them)."""
    rng = np.random.default_rng(seed)
    agent, gt = {}, {}
    for tour in range(3):
        tid = f"tour{seed}_{tour}"
        agent[tid], gt[tid] = [], []
        for ep in range(int(rng.integers(2, 5))):
            for path, n in ((agent[tid], int(rng.integers(3, 12))),
                            (gt[tid], int(rng.integers(3, 12)))):
                pos = rng.normal(0, 2, 3)
                for _ in range(n):
                    pos = pos + rng.normal(0, 0.25, 3) * (rng.random() > 0.2)
                    path.append({"position": pos.round(6).tolist(),
                                 "episode_id": str(ep), "phase": "agent"})
                path.append({"position": rng.normal(0, 2, 3).tolist(),
                             "episode_id": str(ep), "phase": "oracle"})
    return agent, gt


def _dtw_inputs(seed):
    agent, gt = _tour_paths(seed)
    for tid in agent:
        ap = [p for p in jnd.novel_only(agent[tid]) if p["phase"] == "agent"]
        gtp = [p for p in gt[tid] if p["phase"] == "agent"]
        aligns = jnd.alignments_from_paths(ap, gtp)
        yield ([p["position"] for p in ap], [p["position"] for p in gtp],
               aligns)


@pytest.mark.parametrize("engine", ["native", "numpy"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tour_ndtw_equals_the_jax_packages(seed, engine, monkeypatch):
    if engine == "numpy":
        monkeypatch.setattr(jax_native, "dtw_library", lambda: None)
        monkeypatch.setattr(torch_native, "dtw_library", lambda: None)
    else:
        assert torch_native.dtw_library() is not None
        assert jax_native.dtw_library() is not None
    for ap, gtp, aligns in _dtw_inputs(seed):
        assert aligns
        want = jnd._windowed_dtw_dispatch(ap, gtp, aligns)
        assert tnd._windowed_dtw_dispatch(ap, gtp, aligns) == want
        assert np.isfinite(want) and want > 0
        # unconstrained too
        assert (tnd._windowed_dtw_dispatch(ap, gtp, [])
                == jnd._windowed_dtw_dispatch(ap, gtp, []))
    agent, gt = _tour_paths(seed)
    want = jnd.compute_tour_ndtw(agent, gt)
    assert tnd.compute_tour_ndtw(agent, gt) == want
    assert 0 < want < 1
