"""The PyTorch port's Config and package boundary, held against the
reference: byte-identical JSON and digest (artifact manifests carry the
digest), the same validation, and an import graph free of JAX and of
the reference package."""

import os
import re
import subprocess
import sys

import pytest

from xflow_tpu.config import Config as RefConfig
from xflow_tpu.models import model_names
from xflow_tpu_torch.config import MODEL_FAMILIES, Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = [
    {},
    {"model": "lr", "table_size_log2": 14, "max_nnz": 24, "batch_size": 64},
    {"model": "fm", "max_nnz": 40, "v_dim": 10, "optimizer": "ftrl",
     "table_size_log2": 24, "batch_size": 65536, "num_devices": 1,
     "max_fields": 39},
    {"model": "mvm", "v_dim": 6},
    {"model": "ffm", "ffm_v_dim": 4, "microbatch": 4, "batch_size": 64},
    {"model": "wide_deep", "emb_dim": 8, "hidden_dim": 64},
    {"model": "two_tower", "max_fields": 39, "tower_split_field": 20},
    {"model": "dcn", "cross_layers": 3},
    {"chaos_spec": "seed=7;loader.read_block:nth=2;serve.x:p=1,times=4",
     "hash_mode": False, "wire_mode": "full"},
]


@pytest.mark.parametrize("kw", CASES, ids=lambda kw: kw.get("model", "default"))
def test_json_and_digest_match_reference(kw):
    ours, ref = Config(**kw), RefConfig(**kw)
    assert ours.to_json() == ref.to_json()
    assert ours.digest() == ref.digest()
    assert Config.from_json(ref.to_json()) == ours


def test_family_names_match_reference_registry():
    assert MODEL_FAMILIES == model_names()
    with pytest.raises(ValueError) as ours:
        Config(model="nope")
    with pytest.raises(ValueError) as ref:
        RefConfig(model="nope")
    assert str(ours.value) == str(ref.value)


def test_from_json_legacy_transfer_ahead_alias():
    text = RefConfig().to_json().replace(
        '"transfer_ahead_depth"', '"transfer_ahead"'
    )
    assert Config.from_json(text).transfer_ahead_depth == (
        RefConfig.from_json(text).transfer_ahead_depth
    )


@pytest.mark.parametrize("spec", [
    "", ";", "seed=3", "bad site:nth=1", "a:nth=0", "a:p=2", "a:q=1",
    "a:nth=1,every=2", "a:nth=1;a:nth=2", "a:times=2", "a:nth", "a.b:every=3",
])
def test_chaos_spec_validation_matches_reference(spec):
    def outcome(cls):
        try:
            cls(chaos_spec=spec)
        except ValueError as e:
            return str(e)
        return None

    assert outcome(Config) == outcome(RefConfig)


def test_import_leaves_out_jax_and_reference_package():
    code = (
        "import sys\n"
        "import xflow_tpu_torch\n"
        "import xflow_tpu_torch.convert, xflow_tpu_torch.serve.engine\n"
        "import xflow_tpu_torch.serve.batcher, xflow_tpu_torch.serve.__main__\n"
        "import xflow_tpu_torch.ops.build, xflow_tpu_torch.io.loader, xflow_tpu_torch.io.synth\n"
        "import xflow_tpu_torch.trainer, xflow_tpu_torch.train\n"
        "import xflow_tpu_torch.optim, xflow_tpu_torch.ops.train\n"
        "import xflow_tpu_torch.ops.optim, xflow_tpu_torch.utils.logging\n"
        "import xflow_tpu_torch.native, xflow_tpu_torch.native.build\n"
        "import xflow_tpu_torch.io.compact, xflow_tpu_torch.io.container\n"
        "import xflow_tpu_torch.io.packed, xflow_tpu_torch.ops.wire\n"
        "import xflow_tpu_torch.chaos\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'xflow_tpu')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_sources_name_no_jax_or_reference_module():
    """The port and chip_smoke.py import nothing of JAX or the reference
    package — not even lazily inside a function."""
    pat = re.compile(r"\bjax|xflow_tpu\.|from xflow_tpu |import xflow_tpu\b(?!_)")
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "xflow_tpu_torch")):
        paths += [os.path.join(root, f) for f in files
                  if f.endswith((".py", ".cu", ".cuh"))]
    hits = []
    for path in paths:
        with open(path) as f:
            for n, line in enumerate(f, 1):
                if pat.search(line):
                    hits.append(f"{path}:{n}: {line.strip()}")
    assert len(paths) > 20
    assert not hits, "\n".join(hits)


@pytest.mark.parametrize("kw", [
    {"update_mode": "sparse"},
    {"microbatch": 4, "batch_size": 64},
    {"cold_consolidate": True},
    {"cold_consolidate": True, "microbatch": 4, "batch_size": 64},
    {"update_mode": "sequential", "microbatch": 4, "batch_size": 64},
    {"update_mode": "sequential", "microbatch": 128, "batch_size": 65536,
     "sequential_inner": "sparse"},
    {"update_mode": "sequential", "sequential_inner": "sparse"},
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
@pytest.mark.parametrize("model", ["lr", "fm"])
def test_check_trainable_accepts_update_modes(model, kw):
    from xflow_tpu_torch.parallel.step import check_trainable, uses_grad_buffer

    cfg = Config(model=model, **kw)
    check_trainable(cfg)
    sparse = kw.get("update_mode") == "sparse" or kw.get("sequential_inner") == "sparse"
    assert uses_grad_buffer(cfg) == (not sparse)


@pytest.mark.parametrize("kw, item", [
    # the hot table trains now (tests/test_torch_hot_train.py), in every
    # mode; what stays refused with it names its own item
    ({"hot_size_log2": 8, "hot_nnz": 8, "num_devices": 2}, "A13"),
    ({"hot_size_log2": 8, "update_mode": "sequential", "microbatch": 4,
      "batch_size": 64, "sequential_inner": "hot", "input_streams": 2}, "A10"),
    ({"hot_size_log2": 8, "hot_nnz": 8, "update_mode": "sequential",
      "microbatch": 4, "batch_size": 64, "sequential_inner": "sparse",
      "num_devices": 2}, "A13"),
    # the dictionary wire trains, with or without the hot table, but not
    # on two devices (A13)
    ({"wire_dedup": "on", "hot_size_log2": 8, "hot_nnz": 8, "num_devices": 2}, "A13"),
    ({"wire_dedup": "on", "update_mode": "sparse", "num_devices": 2}, "A13"),
])
def test_check_trainable_refuses_hot_table_and_dict_wire(kw, item):
    from xflow_tpu_torch.parallel.step import check_trainable

    with pytest.raises(NotImplementedError, match=item):
        check_trainable(Config(model="fm", **kw))
