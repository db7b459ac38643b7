"""The port's data pipeline, checkpoints, training loop and launcher on the
CPU, against the reference:

- batches (synthetic, two hosts, a memmapped token file, the prefetch
  thread) bit-equal to the reference's ``TokenPipeline``'s, and
  ``write_token_file`` byte-equal;
- checkpoints crossing the packages both ways: a train state the port
  saves restores through the reference's ``restore`` onto the reference's
  template bit for bit, and the reverse; the sidecar, the atomic publish
  and the garbage collection of old steps;
- the loops crossing too: the reference's loop resumes from the port's
  checkpoint and the port's from the reference's, and each continues as
  the other does (losses at 1e-5 relative: the same float32 step in two
  packages);
- resume continuity: 2 steps, then a resumed run to 4, bit-equal to 4
  steps in one run; SIGTERM checkpoints and stops after the current step;
  a straggler step is logged with its index;
- the refusals (an embedding-input arch in the loop, the card without
  one) and the launcher's CPU run (reduced qwen2, loss falling).
"""
import dataclasses
import os
import shutil
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models.model import init_params as jinit_params  # noqa: E402
from repro.train import data as jdata  # noqa: E402
from repro.train.loop import LoopConfig as JLoopConfig  # noqa: E402
from repro.train.loop import train as jtrain  # noqa: E402
from repro.train.optimizer import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.train.optimizer import init_opt_state as jinit_opt  # noqa: E402
from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import train as ltrain  # noqa: E402
from repro_torch.models import init_lm  # noqa: E402
from repro_torch.train import data  # noqa: E402
from repro_torch.train.loop import LoopConfig, train  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig, init_opt_state  # noqa: E402

ARCH = "qwen2-0.5b"
REDUCE = dict(n_layers=2, d_model=32, n_heads=4, vocab=128)
ADAMW = dict(lr=1e-3, warmup_steps=2, total_steps=4)
LOSS_RTOL = 1e-5


def _quiet(*_):
    pass


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("n_hosts,host_id", [(1, 0), (2, 1)])
def test_synthetic_batches_bit_equal(n_hosts, host_id):
    kw = dict(seq_len=12, global_batch=4, vocab=97, seed=5, n_hosts=n_hosts,
              host_id=host_id)
    mine = data.TokenPipeline(data.DataConfig(**kw))
    ref = jdata.TokenPipeline(jdata.DataConfig(**kw))
    for step in (0, 1, 7, 1000):
        a, b = mine.batch_at(step), ref.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def test_token_file_batches_and_prefetch_bit_equal(tmp_path):
    toks = np.random.default_rng(0).integers(0, 1000, 5000)
    data.write_token_file(str(tmp_path / "mine.bin"), toks)
    jdata.write_token_file(str(tmp_path / "ref.bin"), toks)
    assert (tmp_path / "mine.bin").read_bytes() == (tmp_path / "ref.bin").read_bytes()
    kw = dict(seq_len=31, global_batch=3, vocab=1000, seed=2)
    mine = data.TokenPipeline(data.DataConfig(token_file=str(tmp_path / "mine.bin"), **kw))
    ref = jdata.TokenPipeline(jdata.DataConfig(token_file=str(tmp_path / "ref.bin"), **kw))
    got = mine.prefetch(3)
    for step in range(3, 8):
        s, a = next(got)
        b = ref.batch_at(step)
        assert s == step
        for k in a:
            assert np.array_equal(a[k], b[k])
    got.close()
    with pytest.raises(ValueError, match="too small"):
        data.TokenPipeline(data.DataConfig(seq_len=6000, global_batch=1,
                                           vocab=1000, token_file=str(tmp_path / "mine.bin")))


# ----------------------------------------------------------- checkpoints
def _model_and_opt(seed=1):
    cfg = get_arch(ARCH).reduced(**REDUCE)
    model = init_lm(cfg, seed=seed, dtype=torch.float32, device="cpu",
                    trainable=True)
    opt = init_opt_state(dict(model.named_parameters()))
    rng = np.random.default_rng(seed)
    for key in ("m", "v"):
        for t in opt[key].values():
            t.copy_(torch.from_numpy(rng.random(t.shape).astype(np.float32)))
    opt["count"] = torch.tensor(7, dtype=torch.int32)
    return cfg, model, opt


def _ref_template():
    jcfg = jget_arch(ARCH).reduced(**REDUCE)
    params = jinit_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    return {"params": params, "opt": jinit_opt(params)}


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    cfg, model, opt = _model_and_opt()
    tree = ckpt.train_state_to_tree(cfg, model, opt)
    ckpt.save(str(tmp_path), 7, tree, metadata={"loss": 1.5})
    got = jckpt.restore(str(tmp_path), jckpt.latest_step(str(tmp_path)),
                        _ref_template())
    want = jax.tree.map(np.asarray, tree)
    assert jax.tree.structure(jax.tree.map(np.asarray, got)) == \
        jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert np.asarray(a).dtype == b.dtype and np.array_equal(a, b)
    import json
    meta = json.loads((tmp_path / "step_000000007.npz.json").read_text())
    assert meta["step"] == 7 and meta["loss"] == 1.5
    assert meta["n_arrays"] == len(jax.tree.leaves(want))


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    ref = jax.tree.map(np.asarray, _ref_template())
    rng = np.random.default_rng(3)
    ref = jax.tree.map(lambda a: (rng.standard_normal(a.shape).astype(a.dtype)
                                  if a.dtype == np.float32 else a), ref)
    ref["opt"]["count"] = np.asarray(5, np.int32)
    jckpt.save(str(tmp_path), 5, ref)
    cfg, model, opt = _model_and_opt(seed=2)
    step = ckpt.latest_step(str(tmp_path))
    new_opt = ckpt.restore_train_state(cfg, model, opt, str(tmp_path), step)
    back = ckpt.train_state_to_tree(cfg, model, new_opt)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        assert np.array_equal(a, b)
    assert int(new_opt["count"]) == 5


def test_restore_onto_tensors_and_bfloat16(tmp_path):
    """A tensor template comes back as tensors of its type (bfloat16 is
    stored widened to float32), on the requested device."""
    tree = {"a": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
            "b": (torch.ones(3, dtype=torch.int32), np.float32(2.5))}
    ckpt.save(str(tmp_path), 1, tree)
    with np.load(tmp_path / "step_000000001.npz") as f:
        assert sorted(f.files) == ["a", "b/0", "b/1"]
        assert f["a"].dtype == np.float32
    got = ckpt.restore(str(tmp_path), 1, tree, device="cpu")
    assert got["a"].dtype == torch.bfloat16 and torch.equal(got["a"], tree["a"])
    assert isinstance(got["b"], tuple) and torch.equal(got["b"][0], tree["b"][0])
    assert float(got["b"][1]) == 2.5


def test_save_async_publishes_atomically_and_keeps_three(tmp_path):
    for step in range(1, 6):
        ckpt.save_async(str(tmp_path), step, {"x": np.full(4, step)}, keep=3)
    ckpt.wait_pending()
    files = sorted(os.listdir(tmp_path))
    assert files == [f"step_{s:09d}.npz{x}" for s in (3, 4, 5)
                     for x in ("", ".json")]
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    assert jckpt.latest_step(str(tmp_path)) == 5


# ------------------------------------------------------------------ loops
def _configs(tmp, total):
    cfg = get_arch(ARCH).reduced(**REDUCE)
    dkw = dict(seq_len=16, global_batch=2, vocab=cfg.vocab, seed=9)
    lkw = dict(total_steps=total, ckpt_dir=str(tmp), ckpt_every=2,
               log_every=1)
    return cfg, dkw, lkw


def _port_run(tmp, total):
    cfg, dkw, lkw = _configs(tmp, total)
    return train(cfg, AdamWConfig(**ADAMW), data.DataConfig(**dkw),
                 LoopConfig(**lkw), log=_quiet, device="cpu")


def _ref_run(tmp, total):
    cfg, dkw, lkw = _configs(tmp, total)
    jcfg = jget_arch(ARCH).reduced(**REDUCE)
    return jtrain(jcfg, JAdamWConfig(**ADAMW), jdata.DataConfig(**dkw),
                  JLoopConfig(**lkw), log=_quiet)


def _close_losses(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert abs(x - y) <= LOSS_RTOL * abs(y)


def test_resume_continuity_and_the_loops_cross(tmp_path):
    """Port: 4 steps in one run against 2 + a resumed 2 (bit-equal), and
    each package's loop resuming the other's step-2 checkpoint continues as
    the writer's own loop does."""
    _, _, whole = _port_run(tmp_path / "whole", 4)
    _, _, first = _port_run(tmp_path / "port", 2)
    assert first == whole[:2]
    shutil.copytree(tmp_path / "port", tmp_path / "port_for_ref")
    model, _, rest = _port_run(tmp_path / "port", 4)
    assert rest == whole[2:]
    _, _, ref_rest = _ref_run(tmp_path / "port_for_ref", 4)
    _close_losses(ref_rest, rest)

    _ref_run(tmp_path / "ref", 2)
    shutil.copytree(tmp_path / "ref", tmp_path / "ref_for_port")
    _, _, ref_rest = _ref_run(tmp_path / "ref", 4)
    _, _, port_rest = _port_run(tmp_path / "ref_for_port", 4)
    _close_losses(port_rest, ref_rest)
    assert sorted(os.listdir(tmp_path / "ref_for_port"))[-2:] == [
        "step_000000004.npz", "step_000000004.npz.json"]


def test_sigterm_checkpoints_and_stops(tmp_path):
    cfg, dkw, lkw = _configs(tmp_path, 10)
    lkw["ckpt_every"] = 100
    seen = []

    def log(msg):
        seen.append(msg)
        if msg.startswith("[loop] step 1 "):
            os.kill(os.getpid(), signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    _, _, hist = train(cfg, AdamWConfig(**ADAMW), data.DataConfig(**dkw),
                       LoopConfig(**lkw), log=log, device="cpu")
    assert len(hist) == 2 and ckpt.latest_step(str(tmp_path)) == 2
    assert any("preemption requested; checkpointed at 2" in m for m in seen)
    assert signal.getsignal(signal.SIGTERM) is before


def test_straggler_step_is_logged(tmp_path, monkeypatch):
    """A step slower than ``straggler_factor`` x the EMA of the step times
    (after the first 4 steps) is logged with its index: the loop's clock
    made to read 1 s a step and 10 s for step 6."""
    import types

    import repro_torch.train.loop as loop_mod

    durations = iter([1.0] * 6 + [10.0] + [1.0] * 10)
    clock = {"t": 0.0, "start": True}

    def perf_counter():
        if not clock["start"]:
            clock["t"] += next(durations)
        clock["start"] = not clock["start"]
        return clock["t"]

    monkeypatch.setattr(loop_mod, "time",
                        types.SimpleNamespace(perf_counter=perf_counter))
    cfg, dkw, lkw = _configs(tmp_path, 8)
    lkw["ckpt_every"] = 100
    seen = []
    train(cfg, AdamWConfig(**ADAMW), data.DataConfig(**dkw), LoopConfig(**lkw),
          log=seen.append, device="cpu")
    stragglers = [m for m in seen if "STRAGGLER" in m]
    assert len(stragglers) == 1 and stragglers[0].startswith(
        "[loop] STRAGGLER step 6: 10.000s")


def test_loop_refuses_an_embedding_input_arch(tmp_path):
    cfg = get_arch("phi-3-vision-4.2b").reduced()
    with pytest.raises(NotImplementedError, match="loop.py:74-75"):
        train(cfg, AdamWConfig(), data.DataConfig(seq_len=8, global_batch=2,
                                                  vocab=cfg.vocab),
              LoopConfig(total_steps=1, ckpt_dir=str(tmp_path)), device="cpu")


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    _, _, hist = ltrain.main(["--arch", ARCH, "--reduced", "--steps", "6",
                              "--batch", "4", "--seq", "16", "--lr", "3e-3",
                              "--device", "cpu", "--ckpt", str(tmp_path)])
    assert len(hist) == 6 and all(np.isfinite(hist))
    assert hist[-1] < hist[0]
    out = capsys.readouterr().out
    assert "[train] done: loss" in out
    assert ckpt.latest_step(str(tmp_path)) == 6


def test_launcher_refuses_cuda_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ltrain.main(["--arch", ARCH, "--reduced", "--steps", "1",
                     "--ckpt", str(tmp_path)])
