"""The port's checkpoint/restart against ``repro.runtime.checkpoint``.

``tests/test_runtime.py``'s checkpoint cases on trees of torch tensors
(round trip, corruption, keep-k + async, structure mismatch, a partial
async save, bf16 leaves included), and the on-disk format shared with
``repro``: a checkpoint written by either package restores in the other
bit for bit, and the manifests carry the same leaves (files, dtypes,
shapes, sha256, bytes) in the same order.  NamedTuple trees shaped as
``repro``'s ``TrainState`` (which holds the NamedTuple ``OptState``)
round-trip with their types kept and restore from ``repro``'s checkpoints.
"""
import json
import os
from typing import Any, NamedTuple, Optional

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
from repro.runtime import checkpoint as ref_ckpt
from repro_torch.runtime import (
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors, so that parallel
    test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def host_arrays():
    rng = np.random.default_rng(0)
    return {
        "a": rng.normal(size=(4, 5)).astype(np.float32),
        "c": rng.integers(0, 9, size=(3,)).astype(np.int32),
        "d": rng.normal(size=(2, 2)).astype(np.float32),
        "e": rng.normal(size=(3, 1)).astype(np.float16),
        "f": rng.integers(0, 2, size=(2, 3)).astype(bool),
    }


def sample_tree():
    """The reference test's tree (bf16 leaf included) and more: a float16
    leaf, a bool leaf, a list, a tuple and ``None``, keys out of order."""
    h = host_arrays()
    return {
        "z": [torch.as_tensor(h["e"]), (torch.as_tensor(h["f"]),)],
        "b": {"d": torch.as_tensor(h["d"]).to(torch.bfloat16),
              "c": torch.as_tensor(h["c"])},
        "a": torch.as_tensor(h["a"]),
        "n": None,
    }


def ref_tree():
    """``sample_tree`` as ``repro`` holds it (jax arrays)."""
    h = host_arrays()
    return {
        "z": [jnp.asarray(h["e"]), (jnp.asarray(h["f"]),)],
        "b": {"d": jnp.asarray(h["d"]).astype(jnp.bfloat16),
              "c": jnp.asarray(h["c"])},
        "a": jnp.asarray(h["a"]),
        "n": None,
    }


def flat(tree) -> list:
    """Leaves in ``jax.tree.flatten``'s order, as raw bytes + dtype name."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in flat(v)]
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu().contiguous()
        name = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return [(t.numpy().tobytes(), name, tuple(tree.shape))]
    a = np.asarray(tree)
    return [(a.tobytes(), str(a.dtype), a.shape)]


def test_checkpoint_roundtrip(tmp_path):
    tree = sample_tree()
    save_checkpoint(str(tmp_path), 7, tree)
    assert latest_step(str(tmp_path)) == 7
    step, got = restore_checkpoint(str(tmp_path), tree)
    assert step == 7
    assert flat(got) == flat(tree)
    assert got["n"] is None and isinstance(got["z"][1], tuple)
    assert list(got) == list(tree)
    assert got["b"]["d"].dtype == torch.bfloat16


def test_checkpoint_detects_corruption(tmp_path):
    tree = sample_tree()
    path = save_checkpoint(str(tmp_path), 1, tree)
    victim = os.path.join(path, "leaf_00000.bin")
    raw = bytearray(open(victim, "rb").read())
    raw[0] ^= 0xFF
    open(victim, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="checksum"):
        restore_checkpoint(str(tmp_path), tree)
    step, _ = restore_checkpoint(str(tmp_path), tree, validate=False)
    assert step == 1


def test_checkpoint_manager_keeps_k_and_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    tree = sample_tree()
    for s in range(5):
        want = tree["a"].clone()
        mgr.save(s, tree)
        tree["a"].add_(1.0)        # the saved snapshot is already taken
    mgr.wait()
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert dirs == ["step_000000003", "step_000000004"]
    step, got = mgr.restore_latest(tree)
    assert step == 4
    assert torch.equal(got["a"], want)


def test_checkpoint_structure_mismatch(tmp_path):
    tree = sample_tree()
    save_checkpoint(str(tmp_path), 0, tree)
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(str(tmp_path), {"a": tree["a"]})
    bad = dict(tree, a=torch.zeros(5, 4))
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path), bad)


def test_restore_latest_ignores_partial_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    tree = sample_tree()
    mgr.save(1, tree)
    mgr.wait()
    partial = os.path.join(str(tmp_path), "step_000000002.tmp-4242-7")
    os.makedirs(partial)
    open(os.path.join(partial, "leaf_00000.bin"), "wb").write(b"\x00" * 16)
    assert latest_step(str(tmp_path)) == 1
    step, got = mgr.restore_latest(tree)
    assert step == 1
    assert flat(got) == flat(tree)
    mgr.save(3, tree)
    mgr.wait()
    assert latest_step(str(tmp_path)) == 3
    assert os.path.isdir(partial)


def test_failed_async_save_surfaces_on_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    mgr = CheckpointManager(str(blocker), async_save=True)
    mgr.save(0, sample_tree())
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                     # the error is raised once
    assert CheckpointManager(str(tmp_path / "empty")).restore_latest(
        sample_tree()) is None


def _manifest(path) -> dict:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def test_port_checkpoint_restores_in_reference(tmp_path):
    path = save_checkpoint(str(tmp_path), 5, sample_tree())
    step, got = ref_ckpt.restore_checkpoint(str(tmp_path), ref_tree())
    assert step == 5
    assert flat(got) == flat(ref_tree())
    mine = _manifest(path)
    want = _manifest(ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 5,
                                              ref_tree()))
    assert mine["leaves"] == want["leaves"]
    assert {k: mine[k] for k in ("step", "n_leaves")} == {
        k: want[k] for k in ("step", "n_leaves")}


def test_reference_checkpoint_restores_in_port(tmp_path):
    ref_ckpt.save_checkpoint(str(tmp_path), 9, ref_tree())
    step, got = restore_checkpoint(str(tmp_path), sample_tree())
    assert step == 9
    assert flat(got) == flat(sample_tree())
    assert got["b"]["d"].dtype == torch.bfloat16
    assert got["z"][1][0].dtype == torch.bool
    # and the reference's manager reads what the port's manager wrote
    mgr = CheckpointManager(str(tmp_path / "m"), keep=1, async_save=True)
    mgr.save(11, sample_tree())
    mgr.wait()
    step, got = ref_ckpt.CheckpointManager(
        str(tmp_path / "m")).restore_latest(ref_tree())
    assert step == 11 and flat(got) == flat(ref_tree())


class OptState(NamedTuple):
    """``repro.train.optimizer.OptState``'s fields."""
    step: Any
    mu: Any
    nu: Any


class TrainState(NamedTuple):
    """``repro.train.trainer.TrainState``'s fields: a NamedTuple holding a
    NamedTuple."""
    params: Any
    opt: OptState
    residual: Optional[Any]


def train_state(arr, cls=TrainState, opt_cls=OptState):
    """A two-level NamedTuple tree of ``arr`` (torch.as_tensor or
    jnp.asarray) leaves, a bf16 one included."""
    h = host_arrays()
    params = {"w": arr(h["a"]), "b": arr(h["d"])}
    return cls(params=params,
               opt=opt_cls(step=arr(h["c"]),
                           mu={"w": arr(h["a"] * 0.5), "b": arr(h["d"])},
                           nu={"w": arr(h["a"] ** 2), "b": arr(h["d"])}),
               residual=None)


def assert_train_state(got, want):
    assert type(got) is TrainState and type(got.opt) is OptState
    assert got.residual is None
    assert flat(got) == flat(want)


def test_namedtuple_tree_round_trips(tmp_path):
    """save / restore and the synchronous manager keep both NamedTuple
    types (a NamedTuple takes its fields as arguments, not one iterable)."""
    tree = train_state(torch.as_tensor)
    tree = tree._replace(params=dict(
        tree.params, b=tree.params["b"].to(torch.bfloat16)))
    save_checkpoint(str(tmp_path / "a"), 3, tree)
    step, got = restore_checkpoint(str(tmp_path / "a"), tree)
    assert step == 3
    assert_train_state(got, tree)
    assert got.params["b"].dtype == torch.bfloat16
    mgr = CheckpointManager(str(tmp_path / "m"), keep=2, async_save=False)
    mgr.save(4, tree)
    tree.params["w"].add_(1.0)      # the manager saved a snapshot
    step, got = mgr.restore_latest(tree)
    assert step == 4
    assert torch.equal(got.params["w"] + 1.0, tree.params["w"])
    assert_train_state(got._replace(params=tree.params), tree)


def test_reference_namedtuple_checkpoint_restores_in_port(tmp_path):
    """A ``repro.train`` ``TrainState`` checkpoint (``repro``'s own
    NamedTuples, written by ``repro``'s ``save_checkpoint``) restores into
    the port's template of the same fields."""
    from repro.train.optimizer import OptState as RefOptState
    from repro.train.trainer import TrainState as RefTrainState

    ref = train_state(jnp.asarray, RefTrainState, RefOptState)
    ref_ckpt.save_checkpoint(str(tmp_path), 12, ref)
    template = train_state(torch.as_tensor)
    step, got = restore_checkpoint(str(tmp_path), template)
    assert step == 12
    assert_train_state(got, template)
    assert flat(got) == flat(ref)
