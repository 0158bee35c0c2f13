"""The pooled families' train step against the JAX ``TrainStep``, the
second half of tests/test_torch_dense_step.py (whose helpers and
tolerances it uses): dcn and two_tower in the dense, sparse and
sequential modes on the compact and full wires, the bf16 hot flag on w
and emb together, and no launch counted on the CPU."""

import numpy as np
import pytest
import torch

from test_torch_dense_step import CPU, KC, KH, MODES, _check_step_parity, _raw, _step_kw
from xflow_tpu.config import Config as RefConfig
from xflow_tpu.models import make_model as ref_make_model
from xflow_tpu.optim import make_optimizer as ref_make_optimizer
from xflow_tpu.parallel.mesh import make_mesh
from xflow_tpu.parallel.step import init_state as ref_init_state
from xflow_tpu_torch.config import Config
from xflow_tpu_torch.convert import state_from_numpy
from xflow_tpu_torch.io import batch as port_batch
from xflow_tpu_torch.models import make_model
from xflow_tpu_torch.optim import make_optimizer
from xflow_tpu_torch.ops.pool import field_pool, field_pool_grad
from xflow_tpu_torch.parallel.step import TrainStep


@pytest.mark.parametrize("wire", ["compact", "full"])
@pytest.mark.parametrize("mode", ["dense", "dense-mb4", "sparse", "seq-sparse-mb4",
                                  "seq-dense-mb4", "hot-hybrid-mb4"])
@pytest.mark.parametrize("model", ["dcn", "two_tower"])
def test_dcn_two_tower_step_matches_reference(model, mode, wire):
    _check_step_parity(_step_kw(model, "ftrl", wire, **MODES[mode]))


@pytest.mark.parametrize("mode", ["hot-dense", "hot-hybrid-mb4", "hot-inner-sparse-end"])
def test_mxu_bf16_rounds_w_and_emb(mode):
    """A forced ``hot_impl="mxu"`` with bfloat16: the reference rounds the
    hot rows and gradients of every table on the hot path — w and emb
    both in these families — and so does the port (atol 1e-4, one
    bfloat16 step); an unflagged run lands elsewhere on both tables."""
    kw = _step_kw("wide_deep", "ftrl", "compact", hot_impl="mxu", hot_dtype="bfloat16",
                  **MODES[mode])
    step = _check_step_parity(kw, atol=1e-4)
    assert step.hot_bf16
    raws = [_raw(s, 64, KC, KH, 64) for s in (1, 2)]
    states = {}
    for impl in ("mxu", "seg"):
        cfg = Config(**dict(kw, hot_impl=impl))
        st = TrainStep(make_model(cfg), make_optimizer(cfg), cfg, CPU)
        rcfg = RefConfig(**kw)
        ref0 = ref_init_state(ref_make_model(rcfg), ref_make_optimizer(rcfg), rcfg,
                              make_mesh(1))
        states[impl] = state_from_numpy(
            cfg, {n: {k: np.asarray(a) for k, a in t.items()}
                  for n, t in ref0["tables"].items()}, "cpu",
            dense={k: np.asarray(a) for k, a in ref0["dense"].items()})
        for raw in raws:
            st.train(states[impl], st.put_batch(port_batch.make_batch(*raw, 64, KH)))
    for name in ("w", "emb"):
        gap = (states["mxu"]["tables"][name]["z"] - states["seg"]["tables"][name]["z"]).abs()
        assert float(gap.max()) > 1e-7, name


def test_pooled_modes_launch_nothing_on_cpu():
    """Every pooled update mode runs the plain versions on CPU tensors:
    no wrapper counts a launch."""
    before = (field_pool.launches, field_pool_grad.launches)
    _check_step_parity(_step_kw("wide_deep", "ftrl", "compact", **MODES["hot-hybrid-mb4"]),
                       steps=1)
    assert (field_pool.launches, field_pool_grad.launches) == before
