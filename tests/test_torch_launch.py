"""The port's training CLI and supervisor on the CPU: the supervisor drill
of ``tests/test_distributed.py`` (a trainer that crashes at step 6 is
relaunched and resumes from its checkpoint to the end), a run over a
sharded trajectory lake, and a mesh asked for without ``torchrun``."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

SRC = str(Path(__file__).resolve().parents[1] / "src")


def _env():
    return dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))


def test_supervisor_restarts_after_injected_failure(tmp_path):
    hb, ck = str(tmp_path / "hb"), str(tmp_path / "ck")
    cmd = [sys.executable, "-m", "repro_torch.launch.supervisor",
           "--heartbeat", hb, "--max-restarts", "2", "--",
           "--arch", "internlm2-1.8b", "--reduced", "--steps", "12",
           "--global-batch", "4", "--seq", "32", "--ckpt-dir", ck,
           "--ckpt-every", "4", "--fail-at-step", "6", "--device", "cpu"]
    r = subprocess.run(cmd, capture_output=True, text=True, env=_env(), timeout=600)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    assert "restart 1" in r.stdout
    assert "exited cleanly" in r.stdout
    assert "injected failure at step 6" in r.stderr
    assert "[train] resumed from step 4" in r.stdout
    assert open(os.path.join(ck, "latest")).read() == "step_00000012"


def test_cli_trains_from_a_lake(tmp_path):
    from repro_torch.data.synthetic import porto_taxi_like
    from repro_torch.dataset import write_dataset

    lake = str(tmp_path / "lake")
    write_dataset(lake, columns=porto_taxi_like(n_traj=400), sort="hilbert", n_shards=2,
                  device="cpu")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "spatial-lm",
           "--reduced", "--steps", "3", "--global-batch", "2", "--seq", "64",
           "--data-dir", lake, "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2",
           "--device", "cpu"]
    r = subprocess.run(cmd, capture_output=True, text=True, env=_env(), timeout=600)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    assert "[train] step 2 loss=" in r.stdout and "[train] done: 3 steps" in r.stdout
    assert sorted(os.listdir(tmp_path / "ck")) == ["latest", "step_00000002", "step_00000003"]


@pytest.mark.parametrize("args", [["--mesh-data", "2"], ["--mesh-model", "4"]])
def test_cli_mesh_clamps_to_world(tmp_path, args):
    """Started plainly (no ``torchrun``), a mesh larger than the one rank
    there is clamps to (1, 1), as the reference's ``make_host_mesh`` clamps
    to the devices it finds, and the run trains on it to the end."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--reduced", "--device", "cpu",
           "--steps", "2", "--global-batch", "4", "--seq", "32", "--ckpt-every", "2",
           "--ckpt-dir", str(tmp_path / "ck"), *args]
    r = subprocess.run(cmd, capture_output=True, text=True, env=_env(), timeout=300)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    assert "[train] mesh {'data': 1, 'model': 1} over 1 rank(s), backend gloo" in r.stdout
    assert "[train] done: 2 steps" in r.stdout
    assert sorted(os.listdir(tmp_path / "ck")) == ["latest", "step_00000002"]


def test_cli_feed_tokens_match_reference_feed(tmp_path):
    """The CLI's feed reads with no box, as the reference's does. Over a
    two-file Porto lake, a pass and a half of its trips, both give the same
    token batches."""
    import glob

    import numpy as np
    pytest.importorskip("jax")
    from repro.data.pipeline import TrajectoryBatcher as JBatcher
    from repro.data.synthetic import PORTO_BBOX as J_BBOX
    from repro.data.tokenizer import GeoTokenizer as JTokenizer
    from repro_torch.core.writer import write_file
    from repro_torch.data.synthetic import porto_taxi_like
    from repro_torch.launch.train import trajectory_batcher

    for seed in (0, 1):
        write_file(str(tmp_path / f"part{seed}.spqf"),
                   columns=porto_taxi_like(n_traj=200, seed=seed), sort="hilbert", device="cpu")
    mine = trajectory_batcher(str(tmp_path), seq=64, global_batch=4, device="cpu")
    assert mine.bbox is None
    files = sorted(glob.glob(str(tmp_path / "*.spqf")))
    theirs = JBatcher(files, JTokenizer(J_BBOX, order=6), seq_len=64, global_batch=4)
    for i, (a, b) in enumerate(zip(mine, theirs)):
        assert np.array_equal(a["tokens"], b["tokens"]), i
        if i == 150:
            break
    assert i == 150


@pytest.mark.parametrize("lake", ["porto_and_roads_files", "dataset_outside_the_box"])
def test_cli_feed_reads_trips_outside_the_box(tmp_path, lake):
    """Trips outside the tokenizer's box are tokenized onto its edge cells,
    as the reference's feed does, not dropped: over one Porto file and one
    ``roads_like`` file (whose roads lie outside the Porto box) the CLI's
    feed gives the reference's 30 batches token for token, and over a
    dataset whose every shard misses the box it gives the reference's
    batches instead of raising."""
    import glob

    import numpy as np
    pytest.importorskip("jax")
    from repro.data.pipeline import TrajectoryBatcher as JBatcher
    from repro.data.synthetic import PORTO_BBOX as J_BBOX
    from repro.data.tokenizer import GeoTokenizer as JTokenizer
    from repro_torch.core.writer import write_file
    from repro_torch.data.synthetic import porto_taxi_like, roads_like
    from repro_torch.dataset import write_dataset
    from repro_torch.launch.train import trajectory_batcher

    if lake == "porto_and_roads_files":
        write_file(str(tmp_path / "a_porto.spqf"), columns=porto_taxi_like(n_traj=60),
                   sort="hilbert", device="cpu")
        write_file(str(tmp_path / "b_roads.spqf"), columns=roads_like(n_roads=60),
                   sort="hilbert", device="cpu")
        root, sources = str(tmp_path), sorted(glob.glob(str(tmp_path / "*.spqf")))
    else:
        root = str(tmp_path / "roads")
        write_dataset(root, columns=roads_like(n_roads=60), sort="hilbert", n_shards=2,
                      device="cpu")
        sources = [root]
    feeds = (trajectory_batcher(root, seq=32, global_batch=4, device="cpu"),
             JBatcher(sources, JTokenizer(J_BBOX, order=6), seq_len=32, global_batch=4))
    for feed in feeds:
        feed.loop = False   # one pass through the data
    mine, theirs = ([b["tokens"] for b in feed] for feed in feeds)
    if lake == "porto_and_roads_files":
        assert len(theirs) == 30
    assert len(mine) == len(theirs) > 0
    for i, (a, b) in enumerate(zip(mine, theirs)):
        assert np.array_equal(a, b), i
