"""Batched serving example on the PyTorch/CUDA port: trajectory continuation
with the wave scheduler (the twin of ``examples/serve_lm.py``).

Trains a spatial-lm briefly, then serves batched "continue this trajectory"
requests: prompts are tokenized GPS prefixes, responses decode back to
coordinates. ``--device cuda`` (the default) trains and serves on the card;
``--device cpu`` on the CPU. The model trains on one device (``mesh=None``).

    PYTHONPATH=src python examples/torch/serve_lm.py --requests 8 --max-new 24
"""

import argparse
import dataclasses
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--warm-steps", type=int, default=40,
                    help="brief training so generations aren't uniform noise")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import Prefetcher
    from repro_torch.data.synthetic import PORTO_BBOX, porto_taxi_like
    from repro_torch.data.tokenizer import GeoTokenizer
    from repro_torch.serve.scheduler import BatchedServer
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_loop import run_train_loop

    tok = GeoTokenizer(PORTO_BBOX, order=6)
    cfg = dataclasses.replace(get_config("spatial-lm"), vocab=tok.vocab)

    # warm the model on real trajectories so next-token mass is spatial
    from repro_torch.data.pipeline import TrajectoryBatcher
    from repro_torch.core.writer import write_file
    import tempfile
    lake = tempfile.mkdtemp()
    p = os.path.join(lake, "traj.spqf")
    write_file(p, columns=porto_taxi_like(1200, seed=3), sort="hilbert", device=args.device)
    data = Prefetcher(TrajectoryBatcher([p], tok, seq_len=96, global_batch=8,
                                        device=args.device))
    oc = OptConfig(lr=3e-3, warmup_steps=4, total_steps=args.warm_steps)
    state, hist = run_train_loop(cfg, oc, iter(data), global_batch=8,
                                 seq=96, steps=args.warm_steps, log_every=20,
                                 device=args.device)
    params = state.params

    # serve batched continuation requests
    srv = BatchedServer(cfg, params, max_batch=args.max_batch, max_len=192)
    cols = porto_taxi_like(args.requests, seed=9)
    mat = tok.encode_trajectories(cols, 64)
    t0 = time.time()
    for i in range(args.requests):
        prompt = mat[i][mat[i] > 0][:16]  # BOS + 15 cells
        srv.submit(prompt, max_new_tokens=args.max_new, rid=i)
    done = srv.run()
    dt = time.time() - t0
    n_tok = sum(len(r.out_tokens) for r in done)
    print(f"[serve] {len(done)} requests, {n_tok} tokens in {dt:.1f}s "
          f"({n_tok/dt:.1f} tok/s, batch={args.max_batch})")
    for r in sorted(done, key=lambda r: r.rid)[:3]:
        cells = [t for t in r.out_tokens if t >= 3]
        coords = tok.decode_tokens(np.array(cells)) if cells else []
        ttfb = (r.t_first - r.t_submit) * 1e3
        print(f"  req {r.rid}: ttfb {ttfb:.0f}ms, {len(r.out_tokens)} new tokens, "
              f"first coords {np.round(coords[:2], 4).tolist() if len(coords) else '[]'}")


if __name__ == "__main__":
    main()
