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
        "import xflow_tpu_torch.ops.build, xflow_tpu_torch.io.loader\n"
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
