"""The port's retrieval→ranking cascade against the reference, on the
CPU: a two_tower retrieval artifact with its item index and a dcn
ranking artifact, both trained and exported by the JAX package, served
by the port's fleets, CascadeEngine and ServeTier.

* The retrieval fleet's top-k equals the JAX engine's ``topk`` on the
  same user rows: scores within rtol 1e-5 / atol 1e-6 (ROADMAP's parity
  bar), ids equal up to near-ties.
* ``/v1/recommend`` ranks each candidate at the JAX dcn engine's pctr
  of the same user+item row, within atol 1e-6 plus the 5e-7 of the
  response's 6-decimal rounding.
* ``compile_count`` stays flat on both stages under mixed ``k``; a
  ranking-stage rollout over HTTP commits while the retrieval stage
  serves untouched, with 0 errors; starvation is counted, not failed;
  a cascade needs a top-k retrieval stage."""

import http.client
import json
import time

import numpy as np
import pytest

from xflow_tpu.config import Config as RefConfig
from xflow_tpu.serve import artifact as ref_artifact
from xflow_tpu.serve.artifact import export_artifact as ref_export_artifact
from xflow_tpu.serve.engine import PredictEngine as RefEngine
from xflow_tpu.trainer import Trainer as RefTrainer
from xflow_tpu_torch.config import Config
from xflow_tpu_torch.io.loader import make_parse_fn
from xflow_tpu_torch.serve.cascade import CascadeEngine
from xflow_tpu_torch.serve.fleet import ReplicaFleet
from xflow_tpu_torch.serve.server import ServeTier

RTOL, ATOL = 1e-5, 1e-6
PCTR_ATOL = 1e-6 + 5e-7  # the parity bar plus the response's rounding
BUCKETS = (1, 8)
TIMEOUT = 30.0


def _kw(ds, **kw):
    base = dict(train_path=ds.train_prefix, test_path=ds.test_prefix, epochs=1,
                batch_size=64, table_size_log2=14, max_nnz=24, max_fields=12,
                num_devices=1, emb_dim=4, hidden_dim=8)
    base.update(kw)
    return base


TOWER = dict(model="two_tower", tower_dim=5, tower_split_field=6, sgd_lr=0.02)
RANKER = dict(model="dcn", cross_layers=2)


@pytest.fixture(scope="module")
def stages(toy_dataset, tmp_path_factory):
    """The JAX package's two_tower artifact with its item index, and its
    dcn artifact after one epoch (``rank_a``) and two (``rank_b``)."""
    root = tmp_path_factory.mktemp("cascade")
    out = {}
    trainer = RefTrainer(RefConfig(**_kw(toy_dataset, **TOWER)))
    trainer.train()
    out["tower"] = str(root / "tower")
    ref_export_artifact(trainer, out["tower"])
    trainer.close()
    cfg = Config(**_kw(toy_dataset, **TOWER))
    with open(toy_dataset.test_prefix + "-00000", "rb") as f:
        block = make_parse_fn(cfg.table_size, cfg.hash_mode, cfg.seed)(f.read())
    items = ref_artifact.item_catalog_from_block(block, cfg.tower_split_field, 0)
    ref_artifact.export_item_index(RefEngine.load(out["tower"], buckets=BUCKETS, warm=False),
                                   out["tower"], items)
    trainer = RefTrainer(RefConfig(**_kw(toy_dataset, **RANKER)))
    trainer.train()
    out["rank_a"] = str(root / "rank_a")
    ref_export_artifact(trainer, out["rank_a"])
    trainer.train_epoch()
    out["rank_b"] = str(root / "rank_b")
    ref_export_artifact(trainer, out["rank_b"])
    trainer.close()
    users = []
    for i in range(12):
        lo, hi = int(block.row_ptr[i]), int(block.row_ptr[i + 1])
        keys, slots = block.keys[lo:hi].astype(np.int64), block.slots[lo:hi].astype(np.int32)
        sel = slots < cfg.tower_split_field
        users.append((keys[sel], slots[sel], None))
    out["users"] = users
    return out


def _cascade(stages, ranking_art="rank_a", k=4, topk_k=None):
    # admission budgets no loaded CPU box reaches: these tests are not
    # about shedding (the default 50 ms queue age sheds under a stall)
    unshed = dict(deadline_budget_ms=60_000.0, depth_budget=100_000)
    retrieval = ReplicaFleet.load(stages["tower"], replicas=2, device="cpu",
                                  buckets=BUCKETS, topk=True, topk_k=topk_k, revive=False,
                                  **unshed)
    ranking = ReplicaFleet.load(stages[ranking_art], replicas=2, device="cpu",
                                buckets=BUCKETS, cache_capacity=0, revive=False, **unshed)
    return CascadeEngine(retrieval, ranking, k=k)


def _jax_pctr(art, index, user, items):
    """The JAX engine's pctr of the user+item rows the cascade builds."""
    ref = RefEngine.load(art, buckets=BUCKETS, warm=False)
    by_id = {int(i): j for j, i in enumerate(index["item_ids"])}
    ukeys, uslots, _ = user
    rows = []
    for item in items:
        j = by_id[item]
        m = int(index["item_nnz"][j])
        rows.append((np.concatenate([ukeys, index["item_keys"][j, :m]]),
                     np.concatenate([uslots, index["item_slots"][j, :m]]),
                     np.concatenate([np.ones(len(ukeys), np.float32),
                                     index["item_vals"][j, :m]])))
    return ref.predict(ref.featurize_raw(rows))


def _post(port, path, doc):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("POST", path, body=json.dumps(doc))
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _row_doc(user, k=None):
    doc = {"keys": [int(x) for x in user[0]], "slots": [int(x) for x in user[1]]}
    if k is not None:
        doc["k"] = k
    return doc


def test_retrieval_topk_matches_jax_and_keys_stay_flat(stages):
    casc = _cascade(stages)
    ref = RefEngine.load(stages["tower"], buckets=BUCKETS, warm=False)
    try:
        retrieval, ranking = casc.retrieval, casc.ranking
        assert retrieval.engines[0].compile_count == 2 * len(BUCKETS)  # predict + top-k
        assert ranking.engines[0].compile_count == len(BUCKETS)
        want_ids, want_scores = ref.topk(ref.featurize_raw(stages["users"]))
        futs = [retrieval.submit(*u) for u in stages["users"]]
        for f, wi, ws in zip(futs, want_ids, want_scores):
            ids, scores, index = f.result(timeout=TIMEOUT)
            assert index is retrieval.engines[0].item_index
            np.testing.assert_allclose(scores, ws, rtol=RTOL, atol=ATOL)
            got, want = dict(zip(ids.tolist(), scores.tolist())), dict(zip(wi.tolist(),
                                                                          ws.tolist()))
            for i in got.keys() & want.keys():
                assert abs(got[i] - want[i]) <= ATOL + RTOL * abs(want[i])
            for i in got.keys() ^ want.keys():  # a near-tie at the cut may swap
                assert abs(got.get(i, want.get(i)) - ws[-1]) <= ATOL + RTOL * abs(ws[-1])
        for k in (1, 2, 4, 3):
            casc.recommend(*stages["users"][k], k=k, timeout=TIMEOUT)
        assert retrieval.engines[0].compile_count == 2 * len(BUCKETS)
        assert ranking.engines[0].compile_count == len(BUCKETS)
    finally:
        casc.close()


def test_recommend_over_http_matches_jax_and_ranking_rollout(stages):
    casc = _cascade(stages)
    tier = ServeTier(casc.ranking, port=0, poll_s=0.05, cascade=casc).start()
    index = casc.retrieval.engines[0].item_index
    retrieval_engines = list(casc.retrieval.engines)
    retrieval_digest = casc.retrieval.servable
    try:
        user = stages["users"][0]
        status, res = _post(tier.port, "/v1/recommend", _row_doc(user, k=4))
        assert status == 200, res
        assert len(res["items"]) == 4 and res["pctr"] == sorted(res["pctr"], reverse=True)
        np.testing.assert_allclose(res["pctr"], _jax_pctr(stages["rank_a"], index, user,
                                                          res["items"]), atol=PCTR_ATOL)
        status, top = _post(tier.port, "/v1/topk", _row_doc(user, k=4))
        assert status == 200 and set(top["items"][0]) == set(res["items"])
        status, doc = _post(tier.port, "/v1/rollout", {
            "artifact": stages["rank_b"], "stage": "ranking", "canary_frac": 0.5,
            "min_canary_requests": 4})
        assert status == 200, doc
        deadline = time.perf_counter() + TIMEOUT
        while not casc.ranking.rollout_state()["healthy"]:
            assert time.perf_counter() < deadline, casc.ranking.rollout_state()
            status, _ = _post(tier.port, "/v1/recommend", _row_doc(user, k=4))
            assert status == 200
        status, doc = _post(tier.port, "/v1/rollout/commit", {"stage": "ranking"})
        assert status == 200 and doc["committed"]["canary_errors"] == 0
        status, res = _post(tier.port, "/v1/recommend", _row_doc(user, k=4))
        assert status == 200
        np.testing.assert_allclose(res["pctr"], _jax_pctr(stages["rank_b"], index, user,
                                                          res["items"]), atol=PCTR_ATOL)
        # the retrieval stage served untouched
        assert casc.retrieval.engines == retrieval_engines
        assert casc.retrieval.servable == retrieval_digest
        assert casc.retrieval.rollout_state() is None
        assert casc.retrieval.engines[0].compile_count == 2 * len(BUCKETS)
    finally:
        tier.close()
        casc.close()
    row = casc.emit_stats()
    assert row["errors"] == 0


def test_cascade_starvation_counted_and_topk_stage_required(stages):
    casc = _cascade(stages, k=2, topk_k=3)
    try:
        res = casc.recommend(*stages["users"][1], k=5, timeout=TIMEOUT)
        assert len(res["items"]) == 3  # the index width, not the asked 5
        row = casc.emit_stats()
        assert row["starved"] == 1 and row["errors"] == 0
        with pytest.raises(ValueError, match="top-k fleet"):
            CascadeEngine(casc.ranking, casc.ranking, k=1)
    finally:
        casc.close()
