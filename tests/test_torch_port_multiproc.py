"""The port on N processes against the port on one: data-parallel ``fit``
(the loss log, the final weights, BatchNorm statistics and momentum),
per-epoch and standalone data-parallel evaluation, a checkpoint resumed
across processes, the collective stop, the train CLI's multi-process flags,
and the data-parallel step on 4 ranks with dropout and remat (the
counterparts of the JAX package's tests/test_multihost.py and
tests/test_distributed.py).

Every job is gloo on the CPU, each rank a subprocess under a timeout
(``RankJob``, which tests/test_torch_port_parallel.py and the card's
tests/test_torch_port_gpu.py use too). No JAX here: the
reference is the port's own single-process run on the same inputs.
Tolerances: the float64 runs (whose params, momentum, head and loss stay
float32, as everywhere in the port) within 1e-6 of each tensor's largest
|value| and losses within 1e-6 relative, a few float32 ulps: the ranks only
add the same numbers in another order; the CLI's float32 run within 1e-4;
scores within 1e-6; the ranks' states equal bit for bit.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from fastvideotagging_tpu_torch import config as tconfig
from fastvideotagging_tpu_torch.cli import train as cli_train
from fastvideotagging_tpu_torch.data import packed as tpacked
from fastvideotagging_tpu_torch.data.synthetic import make_frames
from fastvideotagging_tpu_torch.evaluation import evaluate as teval
from fastvideotagging_tpu_torch.models.r2plus1d import R2Plus1D
from fastvideotagging_tpu_torch.models.zoo import model_from_config
from fastvideotagging_tpu_torch.train import fit as tfit
from fastvideotagging_tpu_torch.train.loop import make_train_step
from fastvideotagging_tpu_torch.train.state import create_train_state

VIDEOS, VAL_VIDEOS, CLASSES = 8, 3, 3

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 120  # seconds a job's ranks may take together
GROUP_TIMEOUT = 60  # seconds a collective may wait

# Every rank's script starts with this: one thread, the job joined through
# the port's own init_multihost (gloo, on the CPU or all ranks on the one
# card), the mesh made; it puts its results in ``out``, saved as rank<r>.pt
# in the job's directory.
_PRELUDE = r"""
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
rank, world, port, work = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
JOIN = {join}
if JOIN:
    from fastvideotagging_tpu_torch.parallel import init_multihost, make_mesh
    init_multihost(f"127.0.0.1:{{port}}", world, rank, backend="gloo", device="{device}",
                   timeout={timeout})
    mesh = make_mesh(device="{device}")
out = {{}}
"""
_EPILOGUE = r"""
torch.save(out, os.path.join(work, f"rank{rank}.pt"))
import torch.distributed as dist
if dist.is_initialized():
    dist.destroy_process_group()
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class RankJob:
    """``n`` ranks of ``body`` started now; ``results()`` waits for them
    (each a subprocess; all killed at the first failure or the timeout)."""

    def __init__(self, n: int, body: str, work, join: bool = True,
                 timeout: float = RANK_TIMEOUT, device: str = "cpu"):
        self.n, self.work, self.timeout = n, str(work), timeout
        os.makedirs(self.work, exist_ok=True)
        script = os.path.join(self.work, "rank.py")
        with open(script, "w") as f:
            f.write(_PRELUDE.format(join=join, timeout=GROUP_TIMEOUT, device=device) + body
                    + _EPILOGUE)
        self.port = free_port()
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
        env.pop("JAX_PLATFORMS", None)
        self.logs = [os.path.join(self.work, f"rank{r}.log") for r in range(n)]
        self.procs = []
        for r in range(n):
            with open(self.logs[r], "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, script, str(r), str(n), str(self.port), self.work],
                    cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
        self.start = time.monotonic()

    def _kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()

    def results(self) -> list[dict]:
        while True:
            codes = [p.poll() for p in self.procs]
            if all(c == 0 for c in codes):  # done, however long ago
                break
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad or time.monotonic() - self.start > self.timeout:
                self._kill()
                r = bad[0] if bad else 0
                with open(self.logs[r]) as f:
                    tail = f.read()[-4000:]
                pytest.fail(f"rank {r} of {self.n} "
                            f"{'failed' if bad else 'timed out'}:\n{tail}")
            time.sleep(0.05)
        return [torch.load(os.path.join(self.work, f"rank{r}.pt"), weights_only=False)
                for r in range(self.n)]




def _cfg(checkpoint_dir="", epochs=2, resume=False, dtype="float64"):
    return tconfig.ExperimentConfig(
        model=tconfig.ModelConfig(name="tiny3d", num_classes=CLASSES, compute_dtype=dtype),
        data=tconfig.DataConfig(resize_hw=(40, 56), crop_hw=(32, 32),
                                sampler=tconfig.ClipSamplerConfig(clip_len=4, stride=2,
                                                                  num_eval_clips=3),
                                num_workers=1),
        train=tconfig.TrainConfig(batch_size=4, num_epochs=epochs, base_lr=0.05,
                                  weight_decay=1e-3, log_every=1, resume=resume,
                                  checkpoint_dir=checkpoint_dir))


def _state(state) -> dict:
    """The model's state_dict and the momentum buffers, as numpy."""
    out = {k: v.detach().numpy().copy() for k, v in state.model.state_dict().items()}
    for i, s in enumerate(state.optimizer.state.values()):
        out[f"momentum{i}"] = s["momentum_buffer"].detach().numpy().copy()
    return out


def _close(got: dict, want: dict, tol: float):
    assert set(got) == set(want)
    for k in want:
        scale = max(np.abs(want[k]).max(), 1e-30)
        assert np.abs(got[k] - want[k]).max() <= tol * scale, k


def _losses(path):
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return ([(r["step"], r["epoch"], r["loss"]) for r in rows if "loss" in r],
            [(r["step"], r["eval_top1"]) for r in rows if "eval_top1" in r])


_FIT_BODY = r"""
import json, logging, signal
from fastvideotagging_tpu_torch.cli import train as cli_train
from fastvideotagging_tpu_torch.evaluation import evaluate as teval
from fastvideotagging_tpu_torch.data.packed import open_dataset
from fastvideotagging_tpu_torch.models.zoo import model_from_config
from fastvideotagging_tpu_torch.parallel import make_mesh
from fastvideotagging_tpu_torch.train import fit as tfit
spec = torch.load(os.path.join(work, "spec.pt"), weights_only=False)

def state_of(state):
    o = {k: v.detach().numpy().copy() for k, v in state.model.state_dict().items()}
    for i, s in enumerate(state.optimizer.state.values()):
        o[f"momentum{i}"] = s["momentum_buffer"].detach().numpy().copy()
    return o

# the train CLI joins the job itself
state = cli_train.main(spec["argv"] + [
    "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(world),
    "--process-id", str(rank), "--dist-backend", "gloo", "--dist-timeout", "60",
    "--checkpoint-dir", os.path.join(work, "ck_cli"),
    "--metrics-jsonl", os.path.join(work, f"cli{rank}.jsonl")])
out["cli"] = state_of(state)
mesh = make_mesh(device="cpu")
out["world"] = (mesh.world, mesh.rank)
# fit in float64 with per-epoch evaluation, then resumed to a third epoch
state = tfit.fit(spec["fit2"], spec["train"], val_records=spec["val"], mesh=mesh,
                 metrics_path=os.path.join(work, f"fit{rank}.jsonl"))
out["fit2"] = state_of(state)
out["fit3"] = state_of(tfit.fit(spec["fit3"], spec["train"], mesh=mesh))
# evaluation on the mesh: a clip_batch of 3 is rounded up to 4
warnings = []
handler = logging.Handler()
handler.emit = lambda record: warnings.append(record.getMessage())
logging.getLogger("fvt.eval").addHandler(handler)
cfg = spec["fit2"]
model = model_from_config(cfg.model, device="cpu")
ds = open_dataset(spec["val"], cfg.data, mode="eval")
out["scores"], _ = teval.evaluate_video_scores(model, spec["weights"], ds, cfg,
                                               clip_batch=3, mesh=mesh)
out["warnings"] = warnings
# the collective stop: a signal on rank 1 only, after its second step
make = tfit.make_train_step
def signalling(*a, **kw):
    step = make(*a, **kw)
    count = [0]
    def wrapped(*sa, **skw):
        res = step(*sa, **skw)
        count[0] += 1
        if rank == 1 and count[0] == 2:
            os.kill(os.getpid(), signal.SIGINT)
        return res
    return wrapped
tfit.make_train_step = signalling
state = tfit.fit(spec["stop"], spec["train"], mesh=mesh)
out["stop"] = (state.step, sorted(os.listdir(spec["stop"].train.checkpoint_dir)),
               torch.load(os.path.join(spec["stop"].train.checkpoint_dir,
                                       f"step_{state.step}.pt"))["epoch"])
"""


@pytest.fixture(scope="module")
def fit_job(tmp_path_factory):
    work = tmp_path_factory.mktemp("fit")
    train, val = str(work / "train.fvtpack"), str(work / "val.fvtpack")
    tpacked.write_pack_from_arrays(
        [(f"v{i}.mp4", i % CLASSES, (), make_frames(i % CLASSES, 12, 40, 56, seed=i))
         for i in range(VIDEOS)], train, (40, 56))
    tpacked.write_pack_from_arrays(
        [(f"w{i}.mp4", i % CLASSES, (), make_frames(i % CLASSES, 12, 40, 56, seed=50 + i))
         for i in range(VAL_VIDEOS)], val, (40, 56))
    argv = ["--model", "tiny3d", "--num-classes", str(CLASSES), "--train-list", train,
            "--resize", "40", "56", "--crop", "32", "32", "--clip-len", "4", "--stride", "2",
            "--batch-size", "4", "--epochs", "1", "--lr", "0.05", "--log-every", "1",
            "--num-workers", "1", "--compute-dtype", "float32", "--device", "cpu"]
    weights = model_from_config(_cfg().model, device="cpu").state_dict()
    spec = {"argv": argv, "train": train, "val": val, "weights": weights,
            "fit2": _cfg(str(work / "ck_fit")),
            "fit3": _cfg(str(work / "ck_fit"), epochs=3, resume=True),
            "stop": _cfg(str(work / "ck_stop"), epochs=3)}
    torch.save(spec, work / "spec.pt")
    return RankJob(2, _FIT_BODY, work, join=False), spec, work


def test_fit_across_processes_matches_one_process(fit_job, tmp_path):
    """Data-parallel fit over 2 ranks (2 rows of each batch of 4 a rank;
    BatchNorm over the job; gradients averaged) against fit in one
    process: the same loss log and per-epoch eval metrics (written by rank
    0 alone), final weights, BN statistics and momentum within 1e-6; the
    two ranks' states equal bit for bit."""
    job, spec, work = fit_job
    res = job.results()
    assert [r["world"] for r in res] == [(2, 0), (2, 1)]
    cfg = dataclasses.replace(spec["fit2"], train=dataclasses.replace(
        spec["fit2"].train, checkpoint_dir=str(tmp_path / "ck")))
    one = tfit.fit(cfg, spec["train"], val_records=spec["val"], device="cpu",
                   metrics_path=str(tmp_path / "one.jsonl"))
    _close(res[0]["fit2"], _state(one), 1e-6)
    assert all(np.array_equal(res[0]["fit2"][k], res[1]["fit2"][k]) for k in res[0]["fit2"])
    got, want = _losses(work / "fit0.jsonl"), _losses(tmp_path / "one.jsonl")
    assert [s for s, *_ in got[0]] == [s for s, *_ in want[0]] == [1, 2, 3, 4]
    np.testing.assert_allclose([r[2] for r in got[0]], [r[2] for r in want[0]], rtol=1e-6)
    assert got[1] == want[1] and len(got[1]) == 2  # per-epoch eval on the mesh
    assert not os.path.exists(work / "fit1.jsonl")  # only rank 0 logs


def test_resume_across_processes_continues_as_one_process(fit_job, tmp_path):
    """2 ranks resume rank 0's checkpoint of epoch 2 (written once, read by
    both) to a third epoch: the state equals 3 unbroken epochs in one
    process within 1e-6."""
    job, spec, _ = fit_job
    res = job.results()
    cfg = dataclasses.replace(spec["fit3"], train=dataclasses.replace(
        spec["fit3"].train, checkpoint_dir="", resume=False))
    one = tfit.fit(cfg, spec["train"], device="cpu")
    assert one.step == 6
    for r in res:
        _close(r["fit3"], _state(one), 1e-6)


def test_evaluate_across_processes_matches_one_process(fit_job):
    """evaluate_video_scores over 2 ranks (each forwards its half of every
    chunk; the scores all-gathered) equals one process's scores, on every
    rank; a clip_batch of 3 is rounded up to 4 with the reference's
    warning."""
    job, spec, _ = fit_job
    res = job.results()
    cfg = spec["fit2"]
    model = model_from_config(cfg.model, device="cpu")
    ds = tpacked.open_dataset(spec["val"], cfg.data, mode="eval")
    want, _ = teval.evaluate_video_scores(model, spec["weights"], ds, cfg, clip_batch=3)
    for r in res:
        assert r["scores"].shape == (VAL_VIDEOS, CLASSES)
        np.testing.assert_allclose(r["scores"], want, rtol=1e-6, atol=1e-6)
        assert any("clip_batch=3 not divisible by data shards 2; padding chunks to 4" in w
                   for w in r["warnings"])


def test_stop_is_collective_across_processes(fit_job):
    """A signal on rank 1 alone, after its second step: both ranks stop at
    the same step boundary (the stop flag all-reduced with MAX), rank 0's
    checkpoint records the epoch to rerun, and neither rank hangs."""
    job, _, _ = fit_job
    res = job.results()
    steps = {r["stop"][0] for r in res}
    assert steps == {2}
    for r in res:
        step, files, epoch = r["stop"]
        assert f"step_{step}.pt" in files and epoch == 0  # mid-epoch 1: rerun epoch 1


def test_train_cli_joins_the_job(fit_job, tmp_path):
    """cli.train with --coordinator / --num-processes / --process-id on 2
    ranks (float32) ends where the one-process CLI does, within 1e-4; both
    ranks equal; --model-parallel 2 in one process raises the JAX
    make_mesh's ValueError (channel sharding across processes:
    tests/test_torch_port_channel.py)."""
    job, spec, _ = fit_job
    res = job.results()
    one = cli_train.main(spec["argv"] + ["--checkpoint-dir", str(tmp_path / "ck")])
    _close(res[0]["cli"], _state(one), 1e-4)
    assert all(np.array_equal(res[0]["cli"][k], res[1]["cli"][k]) for k in res[0]["cli"])
    with pytest.raises(ValueError, match="model_parallel=2 must divide 1"):
        cli_train.main(spec["argv"] + ["--model-parallel", "2"])
    with pytest.raises(SystemExit, match="needs --num-processes"):
        cli_train.main(spec["argv"] + ["--coordinator", "127.0.0.1:1", "--process-id", "0"])


# --------------------------------------------------------------------------
# the data-parallel step on 4 ranks: one row a rank, dropout, remat
# --------------------------------------------------------------------------

_STEP_BODY = r"""
from fastvideotagging_tpu_torch.models.r2plus1d import R2Plus1D
from fastvideotagging_tpu_torch.parallel import shard_batch
from fastvideotagging_tpu_torch.train.fit import dropout_generator
from fastvideotagging_tpu_torch.train.loop import make_train_step
from fastvideotagging_tpu_torch.train.state import create_train_state
spec = torch.load(os.path.join(work, "spec.pt"), weights_only=False)
for remat in ("none", "full"):
    model = R2Plus1D((1, 1, 1, 1), 5, dtype=torch.float64, dropout=0.5, remat=remat)
    model.load_state_dict(spec["weights"])
    state = create_train_state(spec["cfg"], 10, device="cpu", model=model)
    step = make_train_step(model, spec["cfg"], mesh=mesh)
    losses = []
    for i, batch in enumerate(spec["batches"]):
        state, met = step(state, shard_batch(mesh, batch),
                          dropout_generator(0, i, torch.device("cpu")))
        losses.append(float(met["loss"]))
    out[remat] = ({k: v.numpy().copy() for k, v in model.state_dict().items()}, losses)
"""


@pytest.fixture(scope="module")
def step_job(tmp_path_factory):
    work = tmp_path_factory.mktemp("dp4")
    cfg = tconfig.ExperimentConfig(
        model=tconfig.ModelConfig(name="r2plus1d_18", num_classes=5, compute_dtype="float64",
                                  dropout=0.5),
        data=tconfig.DataConfig(resize_hw=(20, 20), crop_hw=(16, 16),
                                sampler=tconfig.ClipSamplerConfig(clip_len=8)),
        train=tconfig.TrainConfig(batch_size=4, base_lr=0.05))
    rng = np.random.default_rng(2)
    batches = [{"frames": rng.integers(0, 256, size=(4, 8, 20, 20, 3), dtype=np.uint8),
                "labels": np.arange(4, dtype=np.int32),
                "crop_tops": rng.integers(0, 5, size=(4,)).astype(np.int32),
                "crop_lefts": rng.integers(0, 5, size=(4,)).astype(np.int32),
                "flips": rng.uniform(size=(4,)) < 0.5,
                "weights": np.ones((4,), np.float32)} for _ in range(2)]
    model = R2Plus1D((1, 1, 1, 1), 5, dtype=torch.float64, dropout=0.5,
                     generator=torch.Generator().manual_seed(6))
    spec = {"cfg": cfg, "batches": batches, "weights": model.state_dict()}
    torch.save(spec, work / "spec.pt")
    return RankJob(4, _STEP_BODY, work), spec


@pytest.mark.parametrize("remat", ["none", "full"])
def test_data_parallel_step_on_4_ranks_matches_one_process(step_job, remat):
    """Two data-parallel steps over 4 ranks (one row of each batch of 4 a
    rank, so BatchNorm's statistics exist only over the job; dropout 0.5
    drawn as the global batch's mask; remat recomputing the blocks, and
    their BatchNorm all-reduces, in the backward) equal two steps of one
    process on the whole batches: losses within 1e-6, the state within 1e-5
    (the float32 head's rounding, carried back through 16 layers twice, on
    float32 params with momentum); all ranks equal."""
    from fastvideotagging_tpu_torch.train.fit import dropout_generator

    job, spec = step_job
    res = job.results()
    model = R2Plus1D((1, 1, 1, 1), 5, dtype=torch.float64, dropout=0.5, remat=remat)
    model.load_state_dict(spec["weights"])
    state = create_train_state(spec["cfg"], 10, device="cpu", model=model)
    step = make_train_step(model, spec["cfg"])
    losses = []
    for i, batch in enumerate(spec["batches"]):
        state, met = step(state, batch, dropout_generator(0, i, torch.device("cpu")))
        losses.append(float(met["loss"]))
    want = {k: v.numpy() for k, v in model.state_dict().items()}
    got, got_losses = res[0][remat]
    np.testing.assert_allclose(got_losses, losses, rtol=1e-6)
    _close(got, want, 1e-5)
    for r in res[1:]:
        assert all(np.array_equal(got[k], r[remat][0][k]) for k in got)
    assert not np.array_equal(want["fc.weight"], spec["weights"]["fc.weight"].numpy())
