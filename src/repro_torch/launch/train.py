"""Training CLI: ``python -m repro_torch.launch.train --arch <id> [...]``
(``repro/launch/train.py``).

Trains any registry architecture on either the Spatial Parquet trajectory
pipeline (``--data-dir``: a directory of ``.spqf`` files or a sharded
dataset; the paper-integration path) or the structured synthetic stream.
The trajectory feed reads with no query box, as the reference's does: every
trip is tokenized, a point outside the tokenizer's box onto the box's edge
cells. So on ``--device cuda`` (the default) each shard read runs the
page-stream decode on the card and no per-record refine (an unboxed read
is not refined). Always
checkpoint/restart-safe: on boot it restores the latest checkpoint if one
exists, which is what makes the supervisor's kill-and-relaunch loop a
complete fault-tolerance story.

Under ``torchrun`` (``WORLD_SIZE`` set) every rank joins the default
process group (NCCL on ``--device cuda``, each rank on card ``LOCAL_RANK``;
gloo on ``cpu``) and trains on ``make_host_mesh(--mesh-data,
--mesh-model)``: every rank builds the same global batch from the same
files and seed (on the card, kernel 1 runs on every rank) and keeps its
own block of it, as the reference puts one global batch on its mesh. Rank
0 logs and writes checkpoints. Started plainly with the default mesh
flags it trains on one device with no mesh; with larger ones it makes a
one-rank group and the mesh clamps to (1, 1), as the reference clamps to
the devices it finds::

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh-data 2 \
        --mesh-model 2 --device cpu --reduced
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import os
import time


def trajectory_batcher(data_dir, *, seq: int, global_batch: int, accum: int = 1,
                       seed: int = 0, device="cuda"):
    """The CLI's trajectory feed over ``data_dir`` (a directory of ``.spqf``
    files or a sharded dataset): a ``TrajectoryBatcher`` with the Porto
    tokenizer (``.tok``), reading with no box as the reference's CLI does,
    so every shard is read and every trip tokenized."""
    from repro_torch.data.pipeline import TrajectoryBatcher
    from repro_torch.data.synthetic import PORTO_BBOX
    from repro_torch.data.tokenizer import GeoTokenizer
    from repro_torch.dataset import is_dataset

    files = ([data_dir] if is_dataset(data_dir)
             else sorted(glob.glob(os.path.join(data_dir, "*.spqf"))))
    if not files:
        raise SystemExit(f"no .spqf files or dataset in {data_dir}")
    tok = GeoTokenizer(PORTO_BBOX, order=6)
    return TrajectoryBatcher(files, tok, seq_len=seq, global_batch=global_batch,
                             accum=accum, seed=seed, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="spatial-lm")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--data-dir", default=None,
                    help="dir of .spqf files, or a sharded dataset (trajectory LM)")
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--reduced", action="store_true", help="use the smoke-test config")
    ap.add_argument("--heartbeat", default=None)
    ap.add_argument("--fail-at-step", type=int, default=-1, help="fault injection")
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "adafactor"])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch._device import torch_device
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import Prefetcher, synthetic_token_iter
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_loop import _accum_steps, _dp_size, run_train_loop

    torch_device(args.device)   # "cuda" without a card raises before any work
    mesh, rank = _join_mesh(args)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    oc = OptConfig(lr=args.lr, warmup_steps=min(100, args.steps // 10 + 1),
                   total_steps=args.steps, kind=args.optimizer)

    accum = max(cfg.grad_accum, 1)
    if args.global_batch % accum:
        accum = 1
    if mesh is not None:   # each microbatch must tile the batch axes
        accum = _accum_steps(dataclasses.replace(cfg, grad_accum=accum), args.global_batch,
                             _dp_size(mesh))
    if args.data_dir:
        batcher = trajectory_batcher(args.data_dir, seq=args.seq,
                                     global_batch=args.global_batch, accum=accum,
                                     device=args.device)
        cfg = dataclasses.replace(cfg, vocab=max(cfg.vocab, batcher.tok.vocab))
        data = Prefetcher(batcher)
    else:
        data = Prefetcher(synthetic_token_iter(
            cfg.vocab, seq_len=args.seq, global_batch=args.global_batch,
            accum=accum, cfg=cfg))
    cfg = dataclasses.replace(cfg, grad_accum=accum)

    mgr = CheckpointManager(args.ckpt_dir, compress=True, keep=3)

    # fault injection is once-only (a transient fault, not a deterministic
    # crash loop): a marker in the ckpt dir disarms it after the first hit
    fail_at = args.fail_at_step
    marker = os.path.join(args.ckpt_dir, ".fault_injected" + (f".{rank}" if mesh else ""))
    if fail_at >= 0:
        if os.path.exists(marker):
            fail_at = -1
        else:
            os.makedirs(args.ckpt_dir, exist_ok=True)
            with open(marker, "w") as fh:
                fh.write("armed")

    def heartbeat(step):
        if args.heartbeat:
            with open(args.heartbeat, "w") as fh:
                fh.write(str(step))

    t0 = time.time()
    state, history = run_train_loop(
        cfg, oc, iter(data),
        global_batch=args.global_batch, seq=args.seq, steps=args.steps,
        checkpoint_mgr=mgr, checkpoint_every=args.ckpt_every,
        resume=not args.no_resume, heartbeat=heartbeat,
        fail_at_step=fail_at, device=args.device, mesh=mesh,
        log_every=10 if rank == 0 else 0,
    )
    mgr.wait()
    if rank == 0:
        print(f"[train] done: {args.steps} steps in {time.time()-t0:.1f}s; "
              f"final loss {history[-1]['loss']:.4f}" if history else "[train] done")
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()


def _join_mesh(args):
    """(mesh or None, this rank). Under ``torchrun`` join the default group
    and build the mesh; started plainly, no mesh unless the flags ask for
    one, which then lies over a one-rank group and clamps to (1, 1)."""
    if "WORLD_SIZE" not in os.environ and args.mesh_data * args.mesh_model == 1:
        return None, 0
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    backend = "nccl" if args.device.startswith("cuda") else "gloo"
    if "WORLD_SIZE" in os.environ:
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend)
    else:
        if backend == "nccl":
            torch.cuda.set_device(0)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    mesh = make_host_mesh(args.mesh_data, args.mesh_model)
    rank = dist.get_rank()
    if rank == 0:
        print(f"[train] mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} over "
              f"{dist.get_world_size()} rank(s), backend {backend}", flush=True)
    return mesh, rank


if __name__ == "__main__":
    main()
