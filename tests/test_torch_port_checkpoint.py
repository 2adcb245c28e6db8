"""The port's checkpointing (``checkpoint.py`` over
``torch.distributed.checkpoint``) held to the JAX module's rules and cases
(``tests/test_checkpoint.py``).

The single-process cases run the same sequence of saves through both
packages where the rule is the reference's (which steps ``force`` and
``keep`` leave, what raises), and hold the port's round trips to its saved
trees exactly. This file is also the ranks' worker (``python <file>
--worker <dir>``, which imports no JAX): one gloo world of 2 (``{"dp":
2}``) saves a DTensor sharded ``Shard(0)`` over dp and restores it into a
``Replicate`` template, and trains a model through a 4-bit max-min
``DistributedOptimizer`` with error feedback, saving its and its
optimizer's ``state_dict`` midway (the optimizer's through
``stack_ranks``, since each rank's residuals are its own): the run resumed
from the checkpoint gives the same bits as the uninterrupted one.
"""

import collections
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu_torch import checkpoint as ck

WORLD = 2
Pair = collections.namedtuple("Pair", "a b")


def _tree():
    return {"w": torch.arange(32.0).view(8, 4),
            "b": torch.ones(3, 3, dtype=torch.bfloat16) * 1.5,
            "q": torch.tensor([-128, 0, 127], dtype=torch.int8),
            "stats": {"count": 7, "rate": 0.25, "name": "run",
                      "none": None, "scalar": torch.tensor(3.5)},
            "layers": [torch.full((2,), 2.0), [torch.zeros(1), 4]],
            "pair": Pair(torch.ones(2), (5, torch.ones(1)))}


def _same(got, want):
    """The same structure (container types included) and the same bits."""
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)
    else:
        assert got == want


def test_round_trip_keeps_structure_types_and_bits(tmp_path):
    path = str(tmp_path / "ckpt")
    tree = _tree()
    assert ck.save_checkpoint(path, tree, step=3)
    assert ck.latest_checkpoint_step(path) == 3
    back = ck.restore_checkpoint(path)
    _same(back, tree)
    assert all(t.device.type == "cpu" for t in (back["w"], back["b"]))
    # Into a template: its structure, each tensor on its template's device.
    template = ck.checkpoint_metadata(path)
    _same(ck.restore_checkpoint(path, template), tree)


def test_restore_into_a_template_of_another_tree_raises(tmp_path):
    path = str(tmp_path / "ckpt")
    ck.save_checkpoint(path, {"a": torch.ones(2)}, step=0)
    with pytest.raises(ValueError, match="template"):
        ck.restore_checkpoint(path, {"b": torch.ones(2)})


def test_latest_step_and_multiple_steps(tmp_path):
    path = str(tmp_path / "ck")
    tree = _tree()
    ck.save_checkpoint(path, tree, step=1)
    tree2 = dict(tree, w=tree["w"] + 1)
    ck.save_checkpoint(path, tree2, step=2)
    assert ck.latest_checkpoint_step(path) == 2
    _same(ck.restore_checkpoint(path)["w"], tree2["w"])
    _same(ck.restore_checkpoint(path, step=1)["w"], tree["w"])
    with pytest.raises(FileNotFoundError, match="step 5"):
        ck.restore_checkpoint(path, step=5)


def _saves(save, path):
    """A sequence of saves through ``save``; what each did, and the steps
    left after each."""
    log = []
    for step, kw in ((2, {}), (1, dict(force=False)), (1, dict(force=True)),
                     (2, dict(force=False)), (2, dict(force=True)),
                     (11, dict(keep=2)), (12, dict(keep=2)),
                     (13, dict(keep=2)), (14, dict(keep=3))):
        try:
            save(path, {"a": np.ones(3, np.float32)}, step=step, **kw)
            what = "saved"
        except Exception as exc:
            what = "exists" if "exist" in str(exc) else repr(exc)
        log.append((step, what, sorted(
            int(n) for n in os.listdir(path) if n.isdigit())))
    return log


def test_force_and_keep_as_the_reference(tmp_path):
    """``force=False`` skips a step at or below the latest, a step that
    exists raises, ``keep`` keeps the newest: the same steps in both
    packages after each save."""
    import horovod_tpu as hvd

    def port_save(path, tree, step, **kw):
        ck.save_checkpoint(path, {k: torch.from_numpy(v)
                                  for k, v in tree.items()}, step, **kw)

    got = _saves(port_save, str(tmp_path / "port"))
    want = _saves(hvd.save_checkpoint, str(tmp_path / "jax"))
    assert got == want
    assert got[-1][2] == [12, 13, 14]


def test_restore_missing_raises_and_creates_nothing(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        ck.restore_checkpoint(str(tmp_path / "empty"))
    assert not os.path.exists(tmp_path / "empty")
    assert ck.latest_checkpoint_step(str(tmp_path / "nothing")) is None
    assert not os.path.exists(tmp_path / "nothing")
    os.makedirs(tmp_path / "layout")
    with pytest.raises(FileNotFoundError, match="no checkpoint steps"):
        ck.restore_checkpoint(str(tmp_path / "layout"))
    with pytest.raises(FileNotFoundError):
        ck.checkpoint_metadata(str(tmp_path / "nope"))


def test_checkpoint_metadata_reads_shapes_without_data(tmp_path):
    """Meta tensors of the saved shapes and dtypes, with the data files
    removed."""
    path = str(tmp_path / "md")
    ck.save_checkpoint(path, {"a": torch.ones(8, 2, dtype=torch.bfloat16),
                              "b": torch.arange(3), "n": 5}, step=1)
    step_dir = os.path.join(path, "1")
    for name in os.listdir(step_dir):
        if name.endswith(".distcp"):
            os.remove(os.path.join(step_dir, name))
    md = ck.checkpoint_metadata(path)
    assert md["a"].device.type == "meta" and md["a"].shape == (8, 2)
    assert md["a"].dtype == torch.bfloat16
    assert md["b"].shape == (3,) and md["b"].dtype == torch.int64
    assert md["n"] == 5


def test_unreachable_remote_probe_raises_clearly(monkeypatch, tmp_path):
    import fsspec

    def boom(path, **kw):
        raise OSError("no credentials / unreachable endpoint")

    monkeypatch.setattr(fsspec.core, "url_to_fs", boom)
    with pytest.raises(RuntimeError, match="cannot probe remote"):
        ck.latest_checkpoint_step("gs://some-bucket/ckpt")
    with pytest.raises(RuntimeError, match="refusing to write"):
        ck.restore_checkpoint("gs://some-bucket/ckpt")
    with pytest.raises(RuntimeError, match="cannot probe remote"):
        ck.save_checkpoint("gs://some-bucket/ckpt", {"a": torch.ones(1)})


def test_remote_paths_go_through_fsspec(tmp_path):
    """A ``file://`` URL takes the remote route (fsspec's local
    filesystem)."""
    url = f"file://{tmp_path}/remote"
    tree = _tree()
    ck.save_checkpoint(url, tree, step=4)
    assert ck.latest_checkpoint_step(url) == 4
    _same(ck.restore_checkpoint(url), tree)


# ---------------------------------------------------------------------------
# a world of 2 (no JAX)
# ---------------------------------------------------------------------------

def _port_dtensor(out_dir, rank):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = thvd.mesh()
    full = torch.arange(24.0).view(6, 4)
    sharded = distribute_tensor(full, mesh, [Shard(0)])
    path = os.path.join(out_dir, "dtensor")
    ck.save_checkpoint(path, {"x": sharded, "plain": torch.ones(2) * 3,
                              "step": 9}, step=1)
    template = {"x": distribute_tensor(torch.zeros(6, 4), mesh,
                                       [Replicate()]),
                "plain": torch.zeros(2), "step": 0}
    back = ck.restore_checkpoint(path, template)
    try:  # rank 0 alone finds the step; every rank must raise
        ck.save_checkpoint(path, {"x": sharded}, step=1)
        again = None
    except FileExistsError as exc:
        again = str(exc)
    return {"local": back["x"].to_local().numpy(),
            "placements": [type(p).__name__ for p in back["x"].placements],
            "plain": back["plain"].numpy(), "step": back["step"],
            "files": sorted(os.listdir(os.path.join(path, "1"))),
            "again": again}


def _model_and_opt():
    from horovod_tpu_torch.compression import (CompressionConfig,
                                               MaxMinQuantizer)
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(6, 16), torch.nn.ReLU(),
                                torch.nn.Linear(16, 3))
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters(),
        compression=CompressionConfig(MaxMinQuantizer(bits=4,
                                                      bucket_size=64),
                                      error_feedback=True))
    return model, opt


def _train(model, opt, rank, steps):
    rng = np.random.RandomState(rank)
    losses = []
    for _ in range(steps):
        x = torch.from_numpy(rng.randn(4, 6).astype(np.float32))
        opt.zero_grad()
        loss = model(x).pow(2).mean()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    return losses


def _port_resume(out_dir, rank):
    path = os.path.join(out_dir, "resume")
    model, opt = _model_and_opt()
    _train(model, opt, rank, 3)
    residuals = sum(1 for st in opt.state.values() if "hvd_residual" in st)
    # The residuals differ by rank: every rank saves its own.
    state = {"model": model.state_dict(),
             "opt": ck.stack_ranks(opt.state_dict())}
    ck.save_checkpoint(path, state, step=3)
    straight = _train(model, opt, rank + 10, 2)
    fresh, fresh_opt = _model_and_opt()
    saved = ck.restore_checkpoint(path)
    fresh.load_state_dict(saved["model"])
    fresh_opt.load_state_dict(ck.unstack_rank(saved["opt"]))
    resumed = _train(fresh, fresh_opt, rank + 10, 2)
    return {"straight": straight, "resumed": resumed,
            "residual_leaves": residuals,
            "same_params": all(torch.equal(a, b) for a, b in zip(
                model.parameters(), fresh.parameters()))}


def _worker(out_dir):
    rank = int(os.environ["HVDTPU_RANK"])
    thvd.init(device="cpu", mesh_shape={"dp": WORLD})
    try:
        res = {"dtensor": _port_dtensor(out_dir, rank),
               "resume": _port_resume(out_dir, rank)}
    finally:
        thvd.shutdown()
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from conftest import free_port, subprocess_env
    out_dir = str(tmp_path_factory.mktemp("torch_checkpoint"))
    port, procs = free_port(), []
    for rank in range(WORLD):
        env = subprocess_env()
        env.update({"HVDTPU_RANK": str(rank), "HVDTPU_SIZE": str(WORLD),
                    "HVDTPU_LOCAL_RANK": str(rank),
                    "HVDTPU_LOCAL_SIZE": str(WORLD),
                    "HVDTPU_CONTROLLER_ADDR": "127.0.0.1",
                    "HVDTPU_CONTROLLER_PORT": str(port)})
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", out_dir],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    try:
        logs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(out_dir, f"{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


def test_dtensor_shards_restore_into_a_replicated_template(world):
    """Each rank wrote its rows of the ``Shard(0)`` tensor; each gets the
    whole tensor back under ``Replicate``, the plain leaves with it."""
    for res in world:
        got = res["dtensor"]
        np.testing.assert_array_equal(got["local"],
                                      np.arange(24.0).reshape(6, 4))
        assert got["placements"] == ["Replicate"]
        np.testing.assert_array_equal(got["plain"], [3.0, 3.0])
        assert got["step"] == 9
        assert sum(f.endswith(".distcp") for f in got["files"]) == WORLD


def test_collective_save_of_an_existing_step_raises_on_every_rank(world):
    """A DTensor tree saved again at its step: rank 0 finds the step, and
    every rank raises its ``FileExistsError`` (none waits on the others)."""
    for res in world:
        assert res["dtensor"]["again"] is not None
        assert "step 1 already exists" in res["dtensor"]["again"]


def test_resumed_compressed_run_is_bitwise_the_uninterrupted_one(world):
    for res in world:
        got = res["resume"]
        assert got["residual_leaves"] == 4
        assert got["resumed"] == got["straight"]
        assert got["same_params"]


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2])
