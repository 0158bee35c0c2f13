"""CLI entry point of the port's trainer (the reference's train.py):

    python -m xflow_tpu_torch.train --model lr --train PREFIX --test PREFIX \\
        --epochs 10 [--optimizer ftrl] [--table-size-log2 22] ... \\
        [--device cuda|cpu]

The flags are the reference's, plus ``--device`` (default ``cuda``: the
run refuses to start without a card unless ``--device cpu`` is asked
for).  A flag whose feature is not ported exits with code 2, naming the
ROADMAP item that ports it.  The run ends with the reference's
``logloss: ... auc = ...`` line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from xflow_tpu_torch.config import MODEL_FAMILIES, Config

_MODEL_BY_INDEX = {"0": "lr", "1": "fm", "2": "mvm"}  # main.cc:27-45


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="xflow_tpu_torch.train",
        description="sparse CTR trainer on PyTorch/CUDA (the port's train CLI)"
    )
    p.add_argument("--config", help="JSON config file (flags override it)")
    p.add_argument("--train", dest="train_path", help="train shard prefix")
    p.add_argument("--test", dest="test_path", help="test shard prefix")
    p.add_argument(
        "--model",
        choices=[*MODEL_FAMILIES, "0", "1", "2"],
        help="model family (registry: models/__init__.py; numeric "
        "aliases match the reference argv[3])",
    )
    p.add_argument("--epochs", type=int)
    p.add_argument("--optimizer", choices=["ftrl", "sgd"])
    p.add_argument("--batch-size", type=int, dest="batch_size")
    p.add_argument("--table-size-log2", type=int, dest="table_size_log2")
    p.add_argument("--v-dim", type=int, dest="v_dim")
    p.add_argument("--ffm-v-dim", type=int, dest="ffm_v_dim")
    p.add_argument("--emb-dim", type=int, dest="emb_dim")
    p.add_argument("--hidden-dim", type=int, dest="hidden_dim")
    p.add_argument(
        "--tower-split-field", type=int, dest="tower_split_field",
        help="two_tower: fields < split are user-side, >= item-side",
    )
    p.add_argument(
        "--tower-dim", type=int, dest="tower_dim",
        help="two_tower: tower output width (= item-index row width)",
    )
    p.add_argument(
        "--cross-layers", type=int, dest="cross_layers",
        help="dcn: explicit cross-network depth",
    )
    p.add_argument("--max-nnz", type=int, dest="max_nnz")
    p.add_argument("--max-fields", type=int, dest="max_fields")
    p.add_argument("--block-mib", type=int, dest="block_mib")
    p.add_argument(
        "--microbatch", type=int, dest="microbatch",
        help="slices per step (1 = off): in sequential mode each slice "
        "is an optimizer step; in dense mode the reference's gradient "
        "accumulation, which here trains as the whole batch (the same "
        "step: the fused kernel builds no batch-shaped intermediates)",
    )
    p.add_argument(
        "--update-mode", dest="update_mode",
        choices=["dense", "sparse", "sequential"],
        help="dense: gradient scatter-add + full-table optimizer pass; "
        "sparse: per-key consolidation + touched-rows-only update (no "
        "[T, D] gradient buffer); sequential: optimizer applies per --microbatch "
        "slice inside the dispatched step, so the effective optimizer "
        "batch is batch-size/microbatch (small-batch convergence at "
        "device dispatch rates)",
    )
    p.add_argument("--alpha", type=float)
    p.add_argument("--beta", type=float)
    p.add_argument("--lambda1", type=float)
    p.add_argument("--lambda2", type=float)
    p.add_argument("--sgd-lr", type=float, dest="sgd_lr")
    p.add_argument("--seed", type=int)
    p.add_argument("--num-devices", type=int, dest="num_devices")
    p.add_argument("--no-hash", action="store_true", help="numeric fids, keep values")
    p.add_argument(
        "--hot-size-log2", type=int, dest="hot_size_log2",
        help="log2 rows of the frequency-hot MXU table (0 = off)",
    )
    p.add_argument("--hot-nnz", type=int, dest="hot_nnz")
    p.add_argument(
        "--freq-sample-mib", type=int, dest="freq_sample_mib",
        help="MiB of training data sampled to build the hot-key remap",
    )
    p.add_argument(
        "--hot-dtype", choices=["float32", "bfloat16"], dest="hot_dtype"
    )
    p.add_argument(
        "--sequential-inner", dest="sequential_inner",
        choices=["dense", "sparse", "hot"],
        help="per-slice update strategy under --update-mode sequential: "
        "dense = full-table pass (T<=2^24); sparse = touched-rows only "
        "(required at 2^28-scale tables); hot = hot-fine/cold-coarse "
        "(per-slice updates only the hot head, cold tail batched per "
        "dispatch window — needs --hot-size-log2)",
    )
    p.add_argument(
        "--hot-windowend", dest="hot_windowend",
        choices=["auto", "dense", "sparse"],
        help="window-end cold-tail form for --sequential-inner hot: "
        "dense = [T, D] buffer + full-table pass (small tables); "
        "sparse = consolidated touched-rows update, table-size "
        "independent (the 2^28 form; analysis rule XF010/XF014); "
        "auto = sparse from --table-size-log2 24 up",
    )
    p.add_argument(
        "--cold-consolidate", action="store_true", default=None,
        dest="cold_consolidate",
        help="the reference's merge of duplicate keys before the "
        "dense-mode scatter-add; accepted, and trains as dense mode "
        "(the same update: the fused kernel's scatter needs no merge)",
    )
    p.add_argument(
        "--store-mode", choices=["dense", "tiered"], dest="store_mode",
        help="parameter residency (docs/STORE.md): dense = the whole "
        "[T, D] table in device HBM; tiered = bounded HBM hot tier + "
        "host cold store with async promotion — the 2^28-scale form "
        "(FM/MVM/FFM at --table-size-log2 28 only fit this way)",
    )
    p.add_argument(
        "--hot-capacity-log2", type=int, dest="hot_capacity_log2",
        help="log2 rows of the HBM hot tier under --store-mode tiered "
        "(must not exceed --table-size-log2)",
    )
    p.add_argument(
        "--store-promote-every", type=int, dest="store_promote_every",
        help="apply promotion/demotion plans every N train steps",
    )
    p.add_argument(
        "--input-streams", type=int, dest="input_streams",
        help="parallel sharded input fan-out (io/fanout.py): N "
        "concurrent shard-reader streams, each with its own read -> "
        "parse -> compact worker; batch order stays the serial shard "
        "order, so training is bitwise-identical to 1 (the default, "
        "serial reader) — docs/PERF.md \"Input fan-out\"",
    )
    p.add_argument(
        "--transfer-ahead-depth", type=int, dest="transfer_ahead_depth",
        help="device staging ring depth: batches staged ahead on "
        "worker threads (put_batch overlap; >= 2 = double buffering, "
        "deeper absorbs link jitter)",
    )
    p.add_argument(
        "--wire-mode", choices=["auto", "full", "compact"], dest="wire_mode",
        help="host->device batch format; compact ships ~16x fewer "
        "bytes/entry (hash mode; slot-reading models add a u8 slots "
        "plane, ~3x)",
    )
    p.add_argument("--pred-out", dest="pred_out")
    p.add_argument(
        "--pred-style", choices=["single", "per_block"], dest="pred_style",
        help="'per_block': pred_out is a directory; every host writes "
        "pred_<rank>_<block>.txt per eval batch (reference artifact "
        "granularity, lr_worker.cc:74-78)",
    )
    p.add_argument(
        "--metrics-out", dest="metrics_out",
        help="structured metrics JSONL (the reference's obs/schema.py "
        "rows; its `obs summarize` reads them)",
    )
    p.add_argument(
        "--obs-trace-out", dest="obs_trace_out",
        help="host-side span trace (Chrome trace-event JSON for "
        "Perfetto) written here on exit",
    )
    p.add_argument(
        "--obs-trace-capacity", type=int, dest="obs_trace_capacity",
        help="span ring-buffer size (newest N spans kept)",
    )
    p.add_argument(
        "--obs-flight-out", dest="obs_flight_out",
        help="flight-recorder dump path: crash/hang forensics (recent "
        "phases, batch shapes, thread stacks) written here atomically "
        "on unhandled exception, preemption, or watchdog escalation; "
        "read with the reference's `obs doctor RUN --flight FILE`",
    )
    p.add_argument(
        "--obs-watchdog", action="store_true", default=None,
        dest="obs_watchdog",
        help="enable the stall watchdog: classifies hot-loop silence "
        "into input starvation / device hang, emits `health` JSONL "
        "rows, escalates to a flight dump (docs/OBSERVABILITY.md "
        "\"Diagnosing a sick run\")",
    )
    p.add_argument(
        "--obs-watchdog-input-s", type=float, dest="obs_watchdog_input_s",
        help="input-starvation silence threshold, seconds",
    )
    p.add_argument(
        "--obs-watchdog-device-s", type=float, dest="obs_watchdog_device_s",
        help="device-hang silence threshold, seconds",
    )
    p.add_argument(
        "--obs-lock-sanitizer", action="store_true", default=None,
        dest="obs_lock_sanitizer",
        help="arm the lock-order sanitizer (analysis/sanitizer.py): "
        "instrument the obs-stack locks so actual acquisition orders "
        "are recorded and cross-checkable against the static XF007 "
        "graph (docs/ANALYSIS.md); debug/stress tooling, zero "
        "overhead when off",
    )
    p.add_argument("--profile-dir", dest="profile_dir")
    p.add_argument("--profile-steps", type=int, dest="profile_steps")
    p.add_argument("--profile-start-step", type=int, dest="profile_start_step")
    p.add_argument("--checkpoint-dir", dest="checkpoint_dir")
    p.add_argument(
        "--checkpoint-every-steps", type=int, dest="checkpoint_every_steps"
    )
    p.add_argument(
        "--checkpoint-keep", type=int, dest="checkpoint_keep",
        help="keep only the newest K checkpoints (0 = keep all)",
    )
    p.add_argument(
        "--eval-every", type=int, dest="eval_every_epochs",
        help="run evaluation every N epochs during training (0 = only "
        "at the end) — the reference evaluates once, after all epochs "
        "(lr_worker.cc:212-215)",
    )
    p.add_argument(
        "--resume", nargs="?", const="latest", default=None,
        choices=["latest", "auto"],
        help="resume from a checkpoint: bare --resume (or 'latest') "
        "follows the LATEST marker; 'auto' restores the newest "
        "COMPLETE generation, skipping half-written or corrupted ones "
        "with a health row (docs/ROBUSTNESS.md) — the flag to reach "
        "for after a kill/preemption mid-checkpoint",
    )
    p.add_argument(
        "--chaos-spec", dest="chaos_spec",
        help="arm the seeded failpoint fabric, e.g. "
        "'seed=7;loader.read_block:nth=2' (docs/ROBUSTNESS.md; the "
        "XFLOW_CHAOS env var arms the same machinery)",
    )
    p.add_argument(
        "--io-retries", type=int, dest="io_retries",
        help="transient shard-read/parse and cold-store retry budget "
        "per block (exponential backoff; exhausted retries quarantine "
        "the block)",
    )
    p.add_argument(
        "--max-quarantined-frac", type=float, dest="max_quarantined_frac",
        help="abort the stream once quarantined blocks exceed "
        "max(1, ceil(frac * blocks seen)) — skip-and-continue is for "
        "isolated corruption, not a rotten stream",
    )
    p.add_argument(
        "--export-artifact", dest="export_artifact",
        help="after training, freeze the model into a serving artifact "
        "at this directory (serve/artifact.py; score it with "
        "`python -m xflow_tpu_torch.serve`)",
    )
    p.add_argument(
        "--platform",
        choices=["tpu", "cpu", "gpu"],
        help="the reference's backend switch; refused here (multi-host, "
        "ROADMAP A13) — use --device",
    )
    p.add_argument(
        "--coordinator",
        help="host:port of process 0 for multi-host; refused until "
        "multi-host training is ported (ROADMAP A13)",
    )
    p.add_argument("--process-id", type=int)
    p.add_argument("--num-processes", type=int)
    p.add_argument("--skip-eval", action="store_true")
    p.add_argument(
        "--device", default="cuda",
        help="torch device to train on (default: the card; 'cpu' runs "
        "the kernels' plain PyTorch versions on the host)",
    )
    return p


def config_from_args(args: argparse.Namespace) -> Config:
    base = {}
    if args.config:
        with open(args.config) as f:
            base = json.load(f)
    field_names = {f.name for f in dataclasses.fields(Config)}
    for name in field_names:
        val = getattr(args, name, None)
        if val is not None:
            base[name] = val
    if args.model is not None:
        base["model"] = _MODEL_BY_INDEX.get(args.model, args.model)
    if args.no_hash:
        base["hash_mode"] = False
    return Config(**base)


def unported_flags(args: argparse.Namespace) -> str | None:
    """Why a flag of this run cannot be honoured yet, or None."""
    if args.resume:
        return "--resume: checkpoints are not ported yet (ROADMAP A6)"
    if args.platform or args.coordinator:
        return ("--platform / --coordinator: multi-host training is not "
                "ported yet (ROADMAP A13)")
    return None


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    why = unported_flags(args)
    if why is not None:
        print(f"error: {why}", file=sys.stderr)
        return 2
    cfg = config_from_args(args)
    if not cfg.train_path:
        print("error: --train is required", file=sys.stderr)
        return 2
    from xflow_tpu_torch.device import resolve_device
    from xflow_tpu_torch.trainer import Trainer

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    try:
        trainer = Trainer(cfg, device=device)
    except NotImplementedError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    # context manager: the metrics JSONL is flushed and closed on every
    # exit path, including exceptions
    with trainer:
        trainer.train()
        if cfg.test_path and not args.skip_eval:
            trainer.evaluate()
        if args.export_artifact:
            from xflow_tpu_torch.serve.artifact import export_artifact

            path = export_artifact(trainer, args.export_artifact)
            print(f"exported serving artifact to {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
