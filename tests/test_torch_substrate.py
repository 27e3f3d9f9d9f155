"""The port's training substrate against the JAX package, on the CPU: the
data pipeline, the optimizer, checkpoints, the fault-tolerant trainer and
the training launcher (tests/test_substrate.py's cases, through the port).

* ``data.make_batch`` / ``TokenStream`` are bit-identical to the
  reference's for every registry family, step and host split;
* ``optim.adamw_update`` and ``warmup_cosine`` against the reference over
  several steps, float32 and bfloat16 state (1e-6 relative to each leaf's
  largest, float32 math in both; bfloat16 state within one bfloat16 unit);
* checkpoints: round trip, corruption, atomicity, the async writer, and a
  flat dict of arrays written by either package restored by the other;
* ``ResilientTrainer`` learns, recovers from ``flaky`` failures, and
  replays deterministically;
* ``launch/train.py --device cpu`` on a reduced config.
"""
import dataclasses
import json
import math
import pathlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import torch  # noqa: E402

from repro import checkpoint as r_ckpt  # noqa: E402
from repro.data import make_batch as r_make_batch  # noqa: E402
from repro.data import TokenStream as RTokenStream  # noqa: E402
from repro.optim import AdamWConfig as RAdamWConfig  # noqa: E402
from repro.optim import adamw_update as r_adamw  # noqa: E402
from repro.optim import init_opt_state as r_init_opt  # noqa: E402
from repro.optim import warmup_cosine as r_warmup_cosine  # noqa: E402
from repro_torch import checkpoint as CKPT  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import ModelConfig, RunConfig  # noqa: E402
from repro_torch.data import TokenStream, make_batch  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.optim import (AdamWConfig, adamw_update, init_opt_state,  # noqa: E402
                               warmup_cosine)
from repro_torch.runtime.fault_tolerance import ResilientTrainer, flaky  # noqa: E402
from repro_torch.runtime.steps import make_init, make_train_step  # noqa: E402

TINY = ModelConfig(name="t", family="dense", n_layers=2, d_model=32,
                   n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=128,
                   dtype="float32")
RC = RunConfig(xent_chunk=16, attn_chunk_kv=16, learning_rate=2e-3,
               warmup_steps=2)

# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(configs.REGISTRY))
def test_make_batch_is_bit_identical_to_the_reference(arch):
    cfg = configs.scaled_down(configs.resolve(arch))
    seq = 24 + (cfg.frontend_len if cfg.frontend and not cfg.is_encoder_decoder else 0)
    for seed, step, host, n_hosts in ((0, 0, 0, 1), (3, 17, 1, 2), (5, 2**20, 3, 4)):
        got = make_batch(cfg, 8, seq, seed=seed, step=step, host=host, n_hosts=n_hosts)
        want = r_make_batch(cfg, 8, seq, seed=seed, step=step, host=host, n_hosts=n_hosts)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            np.testing.assert_array_equal(got[k], want[k])


def test_stream_prefetch_and_replay_match_the_reference():
    ours, theirs = TokenStream(TINY, 4, 16, seed=1), RTokenStream(TINY, 4, 16, seed=1)
    try:
        for _ in range(3):
            (s1, b1), (s2, b2) = next(ours), next(theirs)
            assert s1 == s2
            np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
        np.testing.assert_array_equal(ours.batch_at(7)["labels"], theirs.batch_at(7)["labels"])
    finally:
        ours.close()
        theirs.close()


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 1, 5, 99, 100, 101, 5000, 100_000, 200_000])
def test_warmup_cosine_matches_the_reference(step):
    kw = dict(peak_lr=3e-4, warmup_steps=100)
    got = float(warmup_cosine(torch.tensor(step, dtype=torch.int32), **kw))
    want = float(r_warmup_cosine(jnp.int32(step), **kw))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_the_reference(state_dtype):
    rng = np.random.default_rng(0)
    shapes = {"w": (8, 6), "b": (6,), "layers": [{"w": (4, 3), "s": (3,)}] * 2}
    tree = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                        is_leaf=lambda x: isinstance(x, tuple))
    kw = dict(weight_decay=0.1, grad_clip=1.0, state_dtype=state_dtype)
    cfg, r_cfg = AdamWConfig(**kw), RAdamWConfig(**kw)
    params = jax.tree.map(torch.tensor, tree)
    r_params = jax.tree.map(jnp.asarray, tree)
    state, r_state = init_opt_state(params, cfg), r_init_opt(r_params, r_cfg)
    for i in range(4):
        g = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.7).astype(np.float32),
                         tree)
        lr = 1e-2 * (i + 1)
        params, state, gn = adamw_update(jax.tree.map(torch.tensor, g), state, params,
                                         lr=lr, cfg=cfg)
        r_params, r_state, r_gn = r_adamw(jax.tree.map(jnp.asarray, g), r_state, r_params,
                                          lr=lr, cfg=r_cfg)
        assert float(gn) == pytest.approx(float(r_gn), rel=1e-6)
        assert int(state["step"]) == int(r_state["step"]) == i + 1
        for name, a, b, tol in (("params", params, r_params, 1e-6),
                                ("m", state["m"], r_state["m"], 1e-6 if state_dtype == "float32" else 2 ** -7),
                                ("v", state["v"], r_state["v"], 1e-6 if state_dtype == "float32" else 2 ** -7)):
            for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
                assert str(x.dtype).split(".")[-1] == str(y.dtype)
                x, y = x.float().numpy(), np.asarray(y, np.float32)
                assert np.abs(x - y).max() <= tol * np.abs(y).max(), name


def test_adamw_decreases_quadratic():
    params = {"w": torch.tensor([3.0, -2.0])}
    cfg = AdamWConfig(weight_decay=0.0, grad_clip=1e9)
    state = init_opt_state(params, cfg)
    for _ in range(200):
        params, state, _ = adamw_update({"w": 2 * params["w"]}, state, params, lr=0.05, cfg=cfg)
    assert float(params["w"].abs().max()) < 0.1


def test_adamw_grad_clip():
    params = {"w": torch.zeros(3)}
    cfg = AdamWConfig(grad_clip=1.0, weight_decay=0.0)
    state = init_opt_state(params, cfg)
    _, state2, gnorm = adamw_update({"w": torch.tensor([1e6, 0.0, 0.0])}, state, params,
                                    lr=0.1, cfg=cfg)
    assert float(gnorm) == pytest.approx(1e6)
    assert float(state2["m"]["w"].abs().max()) <= 0.11  # (1 - b1) x the clip


def test_adamw_bf16_state_roundtrip():
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    cfg = AdamWConfig(state_dtype="bfloat16")
    state = init_opt_state(params, cfg)
    assert state["m"]["w"].dtype == torch.bfloat16
    p2, s2, _ = adamw_update({"w": torch.full((4,), 0.5, dtype=torch.bfloat16)}, state,
                             params, lr=0.01, cfg=cfg)
    assert p2["w"].dtype == torch.bfloat16 and s2["v"]["w"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6).reshape(2, 3), "b": [torch.ones(2), torch.zeros(1)],
            "h": torch.linspace(-2, 2, 5).to(torch.bfloat16), "step": torch.tensor(3, dtype=torch.int32)}
    CKPT.save(tmp_path, 5, tree, extra={"loss": 1.5})
    assert CKPT.latest_step(tmp_path) == 5
    back, extra = CKPT.restore(tmp_path, 5, like=tree)
    got = CKPT.device_put_like(back, "cpu")
    for x, y in zip(torch.utils._pytree.tree_leaves(got), torch.utils._pytree.tree_leaves(tree)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert extra["loss"] == 1.5


def test_checkpoint_detects_corruption(tmp_path):
    tree = {"a": torch.arange(10.0)}
    path = CKPT.save(tmp_path, 1, tree)
    npz = path / "arrays.npz"
    data = bytearray(npz.read_bytes())
    data[-20] ^= 0xFF
    npz.write_bytes(bytes(data))
    with pytest.raises(Exception):
        CKPT.restore(tmp_path, 1, like=tree)


def test_checkpoint_latest_and_atomicity(tmp_path):
    tree = {"a": torch.ones(3)}
    CKPT.save(tmp_path, 1, tree)
    CKPT.save(tmp_path, 2, tree)
    (tmp_path / "step_00000003.tmp").mkdir()  # a crashed save
    assert CKPT.latest_step(tmp_path) == 2


def test_async_checkpointer_snapshots_before_it_returns(tmp_path):
    ck = CKPT.AsyncCheckpointer(tmp_path)
    x = torch.arange(4.0)
    ck.submit(7, {"x": x})
    x.add_(100.0)  # the caller moves on; the checkpoint keeps the old values
    ck.wait()
    assert ck.last_saved == 7
    back, _ = CKPT.restore(tmp_path, 7, like={"x": None})
    np.testing.assert_array_equal(back["x"], np.arange(4.0))


FLAT = {"w": np.arange(12, dtype=np.float32).reshape(3, 4), "i": np.arange(5, dtype=np.int32),
        "h": np.linspace(-1, 1, 6).astype(ml_dtypes.bfloat16)}


def test_a_reference_checkpoint_restores_in_the_port(tmp_path):
    r_ckpt.save(tmp_path, 3, FLAT, extra={"loss": 2.0})
    assert CKPT.latest_step(tmp_path) == 3
    back, extra = CKPT.restore(tmp_path, 3)
    got = CKPT.device_put_like(back, "cpu")
    assert extra == {"loss": 2.0}
    np.testing.assert_array_equal(got["w"].numpy(), FLAT["w"])
    np.testing.assert_array_equal(got["i"].numpy(), FLAT["i"])
    assert got["h"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["h"].float().numpy(), FLAT["h"].astype(np.float32))


def test_a_port_checkpoint_restores_in_the_reference(tmp_path):
    tree = {"w": torch.from_numpy(FLAT["w"]), "i": torch.from_numpy(FLAT["i"]),
            "h": torch.from_numpy(FLAT["h"].astype(np.float32)).to(torch.bfloat16)}
    path = CKPT.save(tmp_path, 4, tree)
    back, _ = r_ckpt.restore(tmp_path, 4)  # the reference's hashes hold
    np.testing.assert_array_equal(back["w"], FLAT["w"])
    np.testing.assert_array_equal(back["i"], FLAT["i"])
    assert back["h"].tobytes() == FLAT["h"].tobytes()
    theirs = r_ckpt.save(tmp_path / "ref", 4, FLAT)
    assert (json.loads((path / "manifest.json").read_text())
            == json.loads((theirs / "manifest.json").read_text()))


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------


def _trainer(tmp_path, hook=None, ckpt_every=5):
    params, opt = make_init(TINY, RC, device="cpu")(torch.Generator().manual_seed(0))
    stream = TokenStream(TINY, 4, 32, seed=0)
    tr = ResilientTrainer(train_step=make_train_step(TINY, RC), stream=stream,
                          ckpt_dir=tmp_path, ckpt_every=ckpt_every, failure_hook=hook)
    return tr, params, opt, stream


def test_trainer_runs_and_learns(tmp_path):
    tr, params, opt, stream = _trainer(tmp_path)
    tr.run(params, opt, 25)
    stream.close()
    assert tr.report.steps_run == 25
    assert tr.report.last_loss < tr.report.losses[0]
    assert CKPT.latest_step(tmp_path) is not None


def test_trainer_recovers_from_failures(tmp_path):
    tr, params, opt, stream = _trainer(tmp_path, hook=flaky({7, 13}), ckpt_every=4)
    tr.run(params, opt, 20)
    stream.close()
    assert tr.report.failures == 2 and tr.report.restores == 2
    assert tr.report.last_loss < tr.report.losses[0]
    hb = json.loads((pathlib.Path(tmp_path) / "heartbeat.json").read_text())
    assert hb["step"] == 19


def test_failure_replay_is_deterministic(tmp_path):
    """A run that fails and restores from its checkpoint ends with the same
    losses as a clean run: restore + counter-based data replay is exact."""
    tr1, p1, o1, s1 = _trainer(tmp_path / "clean", ckpt_every=5)
    tr1.run(p1, o1, 12)
    s1.close()
    tr2, p2, o2, s2 = _trainer(tmp_path / "flaky", hook=flaky({9}), ckpt_every=5)
    tr2.run(p2, o2, 12)
    s2.close()
    assert tr2.report.restores == 1
    # steps 0-8, then 5-11 again from the step-4 checkpoint
    assert tr2.report.losses[:9] == tr1.report.losses[:9]
    assert tr2.report.losses[9:] == tr1.report.losses[5:]


def test_train_launcher_on_the_cpu(tmp_path, capsys):
    report = train_launch.main(["--arch", "qwen3", "--device", "cpu", "--steps", "6",
                                "--batch", "2", "--seq", "32", "--ckpt-dir", str(tmp_path),
                                "--ckpt-every", "2", "--inject-failures", "3"])
    assert report.failures == 1 and report.restores == 1 and report.steps_run == 7
    assert all(math.isfinite(x) for x in report.losses)
    out = capsys.readouterr().out
    assert "[train] qwen3-0.6b reduced=True params=" in out
    assert "failures=1 restores=1" in out
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if torch.cuda.is_available():
            pytest.skip("CUDA is present: the default device is taken")
        train_launch.main(["--arch", "qwen3", "--steps", "1"])
