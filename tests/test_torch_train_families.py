"""The training-families phase's helpers in ``chip_smoke.py`` on the CPU,
at ``reduced()`` widths (the phase runs them at full width on the card):

- :func:`chip_smoke.moe_routes`: a step replaying its own recorded
  experts is the unforced step bit for bit (loss, grad norm, parameters,
  m and v; with and without remat, whose recompute routes again), and a
  replay of other experts changes the step and counts the first layer's
  every pick as moved;
- :func:`chip_smoke.f64_family_check`: the float32 step against a float64
  copy stepped with the float32 run's experts meets ``F64_RTOL`` (loss,
  grad norm, every m and v leaf over its max), for both MoE archs and for
  recurrentgemma-9b at 3 layers past 1024 positions with remat
  (``chunked_attention`` counted on both sides);
- :func:`chip_smoke.train_fits`: the training state the phase's depths
  hold (16 B a parameter, counted under ``FakeTensorMode``), so that a
  config change cannot push the phase off the card unseen.
"""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import init_lm  # noqa: E402
from repro_torch.train import (AdamWConfig, TrainOptions,  # noqa: E402
                               init_opt_state, make_step_fn)

MOE = ["mixtral-8x22b", "qwen3-moe-235b-a22b"]
ADAMW = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def _batch(cfg, seed: int, B: int = 4, S: int = 16) -> dict:
    rng = np.random.default_rng(seed)
    return {k: torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)), dtype=torch.int32)
            for k in ("inputs", "targets")}


def _routed_step(cfg, batch, remat: bool, replay=None):
    model = init_lm(cfg, seed=cs.SEED, dtype=torch.float32, device="cpu",
                    trainable=True)
    opt = init_opt_state(dict(model.named_parameters()))
    step = make_step_fn(cfg, AdamWConfig(**ADAMW), TrainOptions(remat=remat),
                        donate=True)
    with cs.moe_routes(model, replay=replay) as rec:
        _, opt, m = step(model, opt, batch)
    return rec, m, dict(model.named_parameters()), opt


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", MOE)
def test_replayed_routes_give_the_unforced_step_bit_for_bit(arch, remat):
    cfg = get_arch(arch).reduced()
    batch = _batch(cfg, 0)
    rec, ma, pa, oa = _routed_step(cfg, batch, remat)
    assert sorted(rec["sel"]) == [f"layers.{i}.ffn.router" for i in range(cfg.n_layers)]
    rep, mb, pb, ob = _routed_step(cfg, batch, remat, replay=rec)
    assert rep["flips"] == 0 and rep["picks"] == cfg.n_layers * 4 * 16 * cfg.top_k
    assert float(ma["loss"]) == float(mb["loss"])
    assert float(ma["grad_norm"]) == float(mb["grad_norm"])
    for n in pa:
        assert torch.equal(pa[n], pb[n]), n
        for k in ("m", "v"):
            assert torch.equal(oa[k][n], ob[k][n]), (k, n)
    if 2 * cfg.top_k <= cfg.n_experts:     # k experts none picked: another step
        moved = {"sel": {n: torch.topk(torch.ones(s.shape[0], cfg.n_experts)
                                       .scatter_(1, s, 0.0), cfg.top_k).indices
                         for n, s in rec["sel"].items()}}
        rep, mc, _, _ = _routed_step(cfg, batch, remat, replay=moved)
        # layer 0's every pick moves (later layers see another input)
        assert 4 * 16 * cfg.top_k <= rep["flips"] <= rep["picks"]
        assert float(mc["loss"]) != float(ma["loss"])


@pytest.mark.parametrize("arch", MOE)
def test_forced_float64_step_meets_the_f64_bars(arch):
    cfg = get_arch(arch).reduced()
    res = cs.f64_family_check(cfg, _batch(cfg, 1), loss_chunk=4, device="cpu")
    for k, bar in cs.F64_RTOL.items():
        assert res[k] <= bar, (k, res[k])
    assert res["route_picks"] == cfg.n_layers * 4 * 16 * cfg.top_k
    assert 0 <= res["route_flips"] <= res["route_picks"]
    assert res["router"]["m"] <= res["m"] and res["router"]["v"] <= res["v"]


def test_float64_long_step_runs_chunked_attention():
    """recurrentgemma-9b at 3 layers (one group), seq 1088 > 1024, the
    float32 step with remat against float64 without."""
    cfg = get_arch("recurrentgemma-9b").reduced(n_layers=3)
    res = cs.f64_family_check(cfg, _batch(cfg, 2, B=1, S=1088), remat=True,
                              loss_chunk=64, device="cpu")
    for k, bar in cs.F64_RTOL.items():
        assert res[k] <= bar, (k, res[k])
    assert res["chunked_attention_calls"] == [2, 1]
    assert res["route_picks"] == 0


@pytest.mark.parametrize("arch, layers, gib, fits", [
    ("mixtral-8x22b", 1, 43.3, True),
    ("mixtral-8x22b", 2, 80.6, False),
    ("qwen3-moe-235b-a22b", 1, 55.6, True),
    ("qwen3-moe-235b-a22b", 2, 92.7, False),
    ("recurrentgemma-9b", 3, 41.0, True),
    ("recurrentgemma-9b", 5, 48.0, True),
])
def test_train_state_reckoning(arch, layers, gib, fits):
    cfg = dataclasses.replace(get_arch(arch), n_layers=layers)
    ok, got = cs.train_fits(cfg)
    assert round(got, 1) == gib and ok == fits
    if (arch, layers) in cs.FAMILY_RUNS:
        assert ok


def test_family_runs_are_the_fitting_depths():
    """Each MoE arch's depth is the deepest that fits; recurrentgemma's is
    one pattern group and two remainder layers; each float64 depth holds
    every block kind of its arch."""
    from repro_torch.models.model import layer_kind

    for arch, layers in cs.FAMILY_RUNS:
        cfg = get_arch(arch)
        if cfg.is_moe:
            assert not cs.train_fits(dataclasses.replace(cfg, n_layers=layers + 1))[0]
        else:
            assert layers == len(cfg.pattern) + 2
        f64 = cs.FAMILY_F64_LAYERS[arch]
        assert f64 <= layers
        assert {layer_kind(cfg, i) for i in range(f64)} == set(cfg.pattern)
