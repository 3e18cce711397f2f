"""Dry run (``repro/launch/dryrun.py``): prove the distribution config is
coherent at 256 or 512 ranks without a card, and count what each rank does.

For an (architecture x input shape) cell this runs the cell's whole step,
``train_step`` (forward, backward and AdamW) for ``train_*``, the prefill
(``forward_with_cache``) for ``prefill_*``, one decode step against a
``seq_len`` cache for the decode shapes, on

* the single-pod mesh (16, 16), axes (data, model), and
* the multi-pod mesh (2, 16, 16), axes (pod, data, model),

eagerly, on fake tensors (``FakeTensorMode``: shapes, no storage), over a
``"fake"`` process group of 256 or 512 ranks (its collectives move nothing)
as rank 0. Parameters, optimizer state, batches and caches are placed by
the reference's partition rules. :class:`repro_torch.launch.roofline.
StepCounter` counts the rank's FLOPs, bytes and collectives and
``MemTracker`` its peak memory; the roofline terms use H100 figures.

Results are JSON under ``results/dryrun_torch/`` with the reference's keys
(``compile_s`` is the seconds the traced step took). ``--all`` sweeps every
runnable cell, each in a subprocess of its own::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Eager PyTorch runs every layer, so the direct count needs no calibration;
but tracing every layer through DTensor's dispatch takes minutes at full
depth (qwen3-8b ``train_4k``: 36 layers x 16 microbatches), so
``--counting calibrated`` traces only the reference's L-sweep (one and two
periods of layers, the same microbatching) and extrapolates every number,
and ``--counting both`` records the sweep beside the direct count. The fake
group is set up in :func:`main` (or :func:`fake_group`) only; importing
this module touches no process group.

A prefill or decode step reads its cache position once on the host; on
fake tensors the position is a fake made from a constant, which carries its
value: 0 for a prefill, ``seq_len - 1`` for a decode step.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

import torch

from repro_torch.configs import ASSIGNED, SHAPES, ShapeConfig, get_config, shape_applicable
from repro_torch.launch.mesh import MeshShape, make_production_mesh, production_shape
from repro_torch.launch.roofline import (Corrected, StepCounter, collectives_from_trace,
                                         correct_with_calibration, cost_metrics, memory_metrics,
                                         model_flops, peak_flops, roofline_terms)
from repro_torch.models import build_model, tree_leaves, tree_map
from repro_torch.train.optimizer import OptConfig, opt_init
from repro_torch.train.train_loop import (_accum_steps, _dp_size, _forward_batch, batch_struct,
                                          make_prefill_step, make_serve_step, make_train_step,
                                          mesh_layout, place)

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results", "dryrun_torch")


def _meta(shape_dtype) -> torch.Tensor:
    shape, dtype = shape_dtype
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg, shape: ShapeConfig, kind: str | None = None, mesh=None) -> dict:
    """``meta`` tensors (shapes and dtypes, no storage) for every input of a
    cell. With ``mesh``, the train microbatch layout follows the clamped
    grad accumulation the step factory uses there."""
    kind = kind or shape.kind
    model = build_model(cfg)
    pshape = model.init(0, device="meta")
    if kind == "train":
        dp = 1 if mesh is None else _dp_size(mesh)
        accum = _accum_steps(dataclasses.replace(cfg, grad_accum=max(cfg.grad_accum, 1)),
                             shape.global_batch, dp)
        oshape = opt_init(OptConfig(), pshape, cfg.opt_state_dtype)
        bstruct = batch_struct(cfg, shape.global_batch, shape.seq_len, accum)
        return {"params": pshape, "opt_state": oshape,
                "batch": {k: _meta(v) for k, v in bstruct.items()}}
    cache = model.init_cache(shape.global_batch, shape.seq_len, device="meta")
    if kind == "prefill":
        bstruct = _forward_batch(cfg, shape.global_batch, shape.seq_len)
        return {"params": pshape, "batch": {k: _meta(v) for k, v in bstruct.items()},
                "cache": cache}
    return {"params": pshape, "tokens": _meta(((shape.global_batch, 1), torch.int32)),
            "cache": cache}


@contextlib.contextmanager
def fake_group(world: int):
    """The default process group as rank 0 of ``world`` fake ranks."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fake_leaf(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device="cpu")


def _run_step(cfg, shape: ShapeConfig, mesh) -> dict:
    """Trace one step on fake tensors under ``mesh``: the counts, the peak
    and the fallbacks."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor import Replicate

    oc = OptConfig()
    specs = input_specs(cfg, shape, mesh=mesh)
    layout = mesh_layout(cfg, mesh, oc if shape.kind == "train" else None)
    with FakeTensorMode(allow_non_fake_inputs=True) as fake_mode:
        fake = tree_map(_fake_leaf, specs)
        params = place(fake["params"], mesh, layout.params)
        if shape.kind == "train":
            step, _ = make_train_step(cfg, oc, shape.global_batch, shape.seq_len,
                                      device="cpu", mesh=mesh)
            state = (params, place(fake["opt_state"], mesh, layout.opt_state), fake["batch"])
        else:
            if shape.kind == "prefill":
                step, _, new_cache = make_prefill_step(cfg, shape.global_batch, shape.seq_len,
                                                       device="cpu", mesh=mesh)
                first, pos = fake["batch"], 0
            else:
                step, new_cache = make_serve_step(cfg, shape.global_batch, shape.seq_len,
                                                  device="cpu", mesh=mesh)
                first, pos = fake["tokens"], shape.seq_len - 1
            cache = new_cache()
            # the step reads its cache position once on the host: a fake
            # tensor made from a constant carries its value
            cache["pos"] = place(torch.tensor(pos, dtype=torch.int32) + 0, mesh,
                                 (Replicate(),) * mesh.ndim)
            state = (params, first, cache)
        # a first step fills DTensor's sharding-propagation caches, whose
        # misses run each op once more at its global shape; the second step
        # is the rank's own work alone, and the one counted
        t0 = time.perf_counter()
        step(*state)
        secs = time.perf_counter() - t0
        tracker = MemTracker()
        tracker.track_external(*[t for t in tree_leaves({"s": state[:2]}) if torch.is_tensor(t)])
        counter = StepCounter(fake_mode)
        with tracker, counter:
            step(*state)
        peak = max(v.get("Total", 0) for v in tracker.get_tracker_snapshot("peak").values())
    return {"counter": counter, "peak": peak, "secs": secs,
            "fallbacks": sharding_fallbacks(cfg, specs, mesh)}


def sharding_fallbacks(cfg, specs: dict, mesh) -> list[str]:
    """The partition rules' fallback notes for a cell's parameters (and
    cache): :func:`input_specs`'s shapes on ``mesh``."""
    from repro_torch.sharding.specs import cache_specs, param_specs

    notes = param_specs(cfg, mesh, specs["params"])[1]
    if "cache" in specs:
        notes += cache_specs(cfg, mesh, specs["cache"])[1]
    return notes


def one_device_counts(cfg, shape: ShapeConfig) -> dict:
    """FLOPs and bytes (the unfused upper bound) of one ``train_step`` of
    ``cfg`` on one device, no mesh, counted on fake tensors: the work a
    measured step on one card did, for its roofline share."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    if shape.kind != "train":
        raise ValueError("one_device_counts counts train steps")
    oc = OptConfig()
    specs = input_specs(cfg, shape)
    with FakeTensorMode(allow_non_fake_inputs=True) as fake_mode:
        fake = tree_map(_fake_leaf, specs)
        step, _ = make_train_step(cfg, oc, shape.global_batch, shape.seq_len, device="cpu")
        counter = StepCounter(fake_mode)
        with counter:
            step(fake["params"], fake["opt_state"], fake["batch"])
    return {"flops": float(counter.flops), "bytes": float(counter.bytes)}


def _totals(run: dict) -> dict:
    """A traced run's per-rank numbers, flat: FLOPs, bytes, ring and raw
    collective bytes, the peak, and each collective kind's count, bytes and
    link seconds (keys ``<kind>.<field>``)."""
    counter = run["counter"]
    coll = collectives_from_trace(counter.collectives)
    out = {"flops": float(counter.flops), "bytes": float(counter.bytes),
           "coll_ring": sum(c["ring_bytes"] for c in coll.values()),
           "coll_raw": sum(c["raw_bytes"] for c in coll.values()),
           "peak": float(run["peak"])}
    for kind, c in coll.items():
        out.update({f"{kind}.{k}": float(v) for k, v in c.items()})
    return out


def _calib_cfg(cfg, n_layers: int):
    """Small-depth variant for calibration (same widths, shape and
    microbatching)."""
    changes = dict(n_layers=n_layers)
    if cfg.family == "encdec":
        changes["n_encoder_layers"] = n_layers
    return dataclasses.replace(cfg, **changes)


def calibrate(cfg, shape: ShapeConfig, mesh) -> tuple[Corrected, dict, dict]:
    """The reference's L-sweep: runs at one and two periods of layers (and
    one period plus a layer where the depth leaves a remainder), each
    number extrapolated to the full depth as ``outside + (L // p) * group +
    (L % p) * layer`` (peak memory and each collective kind too). Returns
    (corrected totals, the sweep's detail, the extrapolated numbers)."""
    period = cfg.hybrid_attn_every if cfg.family == "hybrid" else 1
    f_p = _totals(_run_step(_calib_cfg(cfg, period), shape, mesh))
    f_2p = _totals(_run_step(_calib_cfg(cfg, 2 * period), shape, mesh))
    keys = set(f_p) | set(f_2p)
    f_p = {k: f_p.get(k, 0.0) for k in keys}
    group = {k: f_2p.get(k, 0.0) - f_p[k] for k in keys}
    outside = {k: f_p[k] - group[k] for k in keys}
    layer = None
    if period > 1 and cfg.n_layers % period:
        f_p1 = _totals(_run_step(_calib_cfg(cfg, period + 1), shape, mesh))
        layer = {k: f_p1.get(k, 0.0) - f_p[k] for k in keys}
    reps, rem = divmod(cfg.n_layers, period)
    full = {k: outside[k] + reps * group[k] + rem * (layer[k] if layer else 0.0) for k in keys}
    corrected = correct_with_calibration(group, layer, outside, cfg.n_layers, period)
    detail = {"per_period": group, "outside": outside, "per_layer_rem": layer,
              "layers": [period, 2 * period] + ([period + 1] if layer else [])}
    return corrected, detail, full


def apply_overrides(cfg, overrides: list[str]):
    """--set key=value config overrides; nested keys use 'ssm.chunk=64'
    style paths into sub-configs."""
    for ov in overrides:
        key, _, raw = ov.partition("=")
        if "." in key:
            sub_name, field = key.split(".", 1)
            sub = getattr(cfg, sub_name)
            cur = getattr(sub, field)
            val = type(cur)(raw) if not isinstance(cur, bool) else raw.lower() in ("1", "true")
            cfg = dataclasses.replace(cfg, **{sub_name: dataclasses.replace(sub, **{field: val})})
        else:
            cur = getattr(cfg, key)
            if isinstance(cur, bool):
                val = raw.lower() in ("1", "true")
            elif cur is None:
                val = raw
            else:
                val = type(cur)(raw)
            cfg = dataclasses.replace(cfg, **{key: val})
    return cfg


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, counting: str = "direct",
             overrides: list[str] | None = None, cfg=None, shape: ShapeConfig | None = None,
             mesh_shape: MeshShape | None = None) -> dict:
    """One cell on the default (fake) group. ``counting``: ``"direct"``
    traces the full depth; ``"calibrated"`` only the L-sweep (one and two
    periods of layers, far quicker at full depth) and extrapolates;
    ``"both"`` records the sweep beside the direct count. ``cfg``,
    ``shape`` and ``mesh_shape`` replace the registry's config, the named
    shape and the production mesh (tests and small runs)."""
    if counting not in ("direct", "calibrated", "both"):
        raise ValueError(f"counting must be direct, calibrated or both, not {counting!r}")
    from torch.distributed.device_mesh import init_device_mesh

    cfg = apply_overrides(cfg or get_config(arch), overrides or [])
    shape = shape or SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped", "reason": why}
    if mesh_shape is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    else:
        mesh = init_device_mesh("cpu", mesh_shape.shape, mesh_dim_names=mesh_shape.axis_names)
    n_ranks = mesh.size()
    print(f"[dryrun] {arch} x {shape_name} mesh="
          f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} ({n_ranks} ranks)", flush=True)
    rec: dict = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                 "chips": n_ranks, "status": "ok", "overrides": overrides or []}
    rec["counting"] = counting
    if counting == "calibrated":
        # the full-depth trace is not run: every number comes from the L-sweep
        t0 = time.perf_counter()
        corrected, detail, full = calibrate(cfg, shape, mesh)
        rec["compile_s"] = time.perf_counter() - t0
        rec["sharding_fallbacks"] = sharding_fallbacks(cfg, input_specs(cfg, shape, mesh=mesh),
                                                       mesh)
        peak = full["peak"]
        coll = {}
        for k, v in full.items():
            if "." in k:
                kind, field = k.split(".")
                coll.setdefault(kind, {})[field] = int(round(v)) if field == "count" else v
        rec["cost_raw"] = {"flops": corrected.flops, "bytes": corrected.bytes,
                           "transcendentals": None}
        rec["calibration"] = {**detail, "corrected": dataclasses.asdict(corrected)}
        direct = corrected
    else:
        run = _run_step(cfg, shape, mesh)
        rec["compile_s"] = run["secs"]
        rec["sharding_fallbacks"] = run["fallbacks"]
        peak = run["peak"]
        rec["cost_raw"] = cost_metrics(run["counter"])
        coll = collectives_from_trace(run["counter"].collectives)
        direct = Corrected(**{k: v for k, v in _totals(run).items()
                              if k in ("flops", "bytes", "coll_ring", "coll_raw")})
        rec["calibration"] = None
        if counting == "both":
            corrected, detail, _ = calibrate(cfg, shape, mesh)
            rec["calibration"] = {**detail, "corrected": dataclasses.asdict(corrected),
                                  "flops_vs_direct": corrected.flops / max(direct.flops, 1.0)}
    rec["memory"] = memory_metrics(peak)
    rec["collectives"] = coll
    rec["corrected"] = dataclasses.asdict(direct)
    print(f"    traced {rec['compile_s']:.1f}s; memory: {rec['memory']}")
    print(f"    collectives: { {k: v['count'] for k, v in coll.items()} }")
    terms = roofline_terms(direct.flops, direct.bytes, direct.coll_ring,
                           collective_s=sum(c["link_s"] for c in coll.values()),
                           flops_peak=peak_flops(cfg.dtype))
    rec["roofline"] = terms
    mf = model_flops(cfg, shape)
    rec["model_flops_global"] = mf
    rec["model_flops_per_chip"] = mf / n_ranks
    rec["useful_flops_ratio"] = (mf / n_ranks) / direct.flops if direct.flops else 0.0
    print(f"    roofline: compute={terms['compute_s']*1e3:.2f}ms "
          f"memory={terms['memory_s']*1e3:.2f}ms "
          f"collective={terms['collective_s']*1e3:.2f}ms "
          f"dominant={terms['dominant']} frac={terms['roofline_fraction']:.2f} "
          f"useful={rec['useful_flops_ratio']:.2f}", flush=True)
    return rec


def cell_path(arch, shape_name, multi_pod, tag=""):
    os.makedirs(RESULTS_DIR, exist_ok=True)
    pod = "pod2" if multi_pod else "pod1"
    suffix = f"_{tag}" if tag else ""
    return os.path.join(RESULTS_DIR, f"{arch}__{shape_name}__{pod}{suffix}.json")


def runnable_cells():
    for arch in ASSIGNED:
        cfg = get_config(arch)
        for shape_name, shape in SHAPES.items():
            yield arch, shape_name, shape_applicable(cfg, shape)[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--all", action="store_true", help="sweep all cells (subprocess per cell)")
    ap.add_argument("--counting", default="direct", choices=["direct", "calibrated", "both"],
                    help="trace the full depth, or only the L-sweep and extrapolate, or both")
    ap.add_argument("--force", action="store_true", help="recompute cached cells")
    ap.add_argument("--tag", default="", help="results filename tag")
    ap.add_argument("--set", action="append", default=[], dest="overrides",
                    help="config override key=value (repeatable)")
    args = ap.parse_args()

    if args.all:
        failures = []
        for arch, shape_name, ok in runnable_cells():
            for mp in (False, True):
                path = cell_path(arch, shape_name, mp, args.tag)
                if os.path.exists(path) and not args.force:
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape_name]
                cmd.append("--multi-pod" if mp else "--single-pod")
                cmd += ["--counting", args.counting]
                if args.tag:
                    cmd += ["--tag", args.tag]
                for ov in args.overrides:
                    cmd += ["--set", ov]
                print(f"=== {arch} x {shape_name} {'pod2' if mp else 'pod1'} ===", flush=True)
                r = subprocess.run(cmd, cwd=os.getcwd())
                if r.returncode != 0:
                    failures.append((arch, shape_name, mp))
                    with open(path, "w") as fh:
                        json.dump({"arch": arch, "shape": shape_name, "multi_pod": mp,
                                   "status": "error", "returncode": r.returncode}, fh)
        print(f"sweep done; {len(failures)} failures: {failures}")
        sys.exit(1 if failures else 0)

    if not (args.arch and args.shape):
        ap.error("--arch and --shape required (or --all)")
    mp = bool(args.multi_pod)
    path = cell_path(args.arch, args.shape, mp, args.tag)
    with fake_group(production_shape(multi_pod=mp).size):
        try:
            rec = run_cell(args.arch, args.shape, multi_pod=mp, counting=args.counting,
                           overrides=args.overrides)
        except Exception:
            traceback.print_exc()
            rec = {"arch": args.arch, "shape": args.shape, "multi_pod": mp,
                   "status": "error", "traceback": traceback.format_exc()}
            with open(path, "w") as fh:
                json.dump(rec, fh, indent=1)
            sys.exit(1)
    with open(path, "w") as fh:
        json.dump(rec, fh, indent=1)
    print(f"[dryrun] saved {path}")


if __name__ == "__main__":
    main()
