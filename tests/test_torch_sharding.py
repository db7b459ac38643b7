"""The port's mesh shardings and stand-ins against the reference's, as pure
data and exactly, for all ten archs on the two production meshes (16x16,
2x16x16) and on (2, 2, 2):

* ``train/sharding.py``: ``param_specs`` (with and without the EP axis),
  ``zero1_opt_specs``, ``batch_specs``, ``cache_specs``.  The port keeps one
  tensor per layer where the reference stacks a pattern group's layers
  (a leading ``n_groups`` dim): a port spec is the reference's spec of the
  stacked leaf with its leading entry dropped.  ZeRO-1 specs are compared
  on the stacked shapes (``reference_zero1_specs``); where the reference
  shards the group dim itself (whole layers' moments on different dp
  ranks), the port's per-layer spec takes those axes on the layer's own
  first free divisible dim (``unstack_spec``), which is checked as that
  rule.
* ``launch/specs.py``: ``abstract_params``, ``abstract_opt_state`` and
  ``input_specs`` against ``jax.eval_shape`` (shapes and types);
  ``model_flops`` and ``analytic_memory_floor``.
* ``named``: specs as DTensor placements on a mesh.
"""
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS, SHAPES  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs import get_shape as jget_shape  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.train import sharding as jsharding  # noqa: E402
from repro_torch.configs import get_arch, get_shape  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.train import sharding  # noqa: E402

ARCH_NAMES = sorted(ARCHS)
# (shape, axis names): the two production meshes and the small-script mesh
MESHES = (((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 2, 2), ("pod", "data", "model")))
_DT = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32,
       jnp.int32: torch.int32}


def _dtype(d):
    return _DT[jnp.dtype(d).type]


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return jspecs.abstract_params(jget_arch(arch))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return specs.abstract_params(get_arch(arch))


def _by_path(tree):
    """``{("groups", "0", "core", "wq"): leaf}`` of a reference tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {tuple(str(getattr(e, "key", getattr(e, "idx", e))) for e in p): l
            for p, l in flat}


def _sizes(shape, names):
    return dict(zip(names, shape))


def _tup(spec):
    return tuple(spec)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_match_reference(arch):
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    port, ref = _port_params(arch), _ref_params(arch)
    for shape, names in MESHES:
        sz = _sizes(shape, names)
        for ep_axis in (None, "data"):
            ep_size = sz["data"] if ep_axis else 1
            want = _by_path(jsharding.param_specs(
                jcfg, ref, "model", sz["model"], ep_axis=ep_axis,
                ep_size=ep_size))
            got = sharding.param_specs(cfg, port, "model", sz["model"],
                                       ep_axis=ep_axis, ep_size=ep_size)
            assert {tuple(sharding.reference_path(cfg, n, port[n].shape)[0])
                    for n in got} == set(want)
            for name, spec in got.items():
                parts, _, stacked = sharding.reference_path(
                    cfg, name, port[name].shape)
                w = _tup(want[tuple(parts)])
                if stacked and w:
                    assert w[0] is None, (name, w)
                    w = w[1:]
                assert spec == w, (arch, shape, ep_axis, name, spec, w)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_zero1_opt_specs_match_reference(arch):
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    port, ref = _port_params(arch), _ref_params(arch)
    opt_abs = jspecs.abstract_opt_state(ref)
    n_lead_sharded = 0
    for shape, names in MESHES:
        sz = _sizes(shape, names)
        dp = ("pod", "data") if "pod" in names else ("data",)
        jp = jsharding.param_specs(jcfg, ref, "model", sz["model"])
        want = _by_path(jsharding.zero1_opt_specs(
            jp, opt_abs, dp, types.SimpleNamespace(shape=sz))["m"])
        pspecs = sharding.param_specs(cfg, port, "model", sz["model"])
        stacked_p = sharding.reference_param_specs(cfg, port, "model",
                                                   sz["model"])
        got_stacked = sharding.reference_zero1_specs(cfg, stacked_p, port, dp,
                                                     sz)
        mesh = types.SimpleNamespace(mesh_dim_names=names,
                                     mesh=torch.empty(shape))
        got = sharding.zero1_opt_specs(cfg, pspecs, port, dp, mesh)
        assert got["count"] == () and got["v"] == got["m"]
        for name, spec in got_stacked.items():
            parts, _, stacked = sharding.reference_path(cfg, name,
                                                        port[name].shape)
            w = _tup(want[tuple(parts)])
            assert spec == w, (arch, shape, name, spec, w)
            per_layer = got["m"][name]
            if stacked and w and w[0] is not None:
                n_lead_sharded += 1
                assert per_layer == sharding._shard_m(
                    pspecs[name], tuple(port[name].shape), dp, sz)
            else:
                assert per_layer == (w[1:] if stacked and w else w)
    if arch == "starcoder2-7b":   # 32 groups: the reference shards them
        assert n_lead_sharded > 0


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_batch_and_cache_specs_match_reference(arch):
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    for dp in (("data",), ("pod", "data"), None):
        for embeds in (True, False):
            if dp is not None:
                want = jsharding.batch_specs(jcfg, dp, embeds)
                got = sharding.batch_specs(cfg, dp, embeds)
                assert {k: _tup(v) for k, v in want.items()} == got
        wg, we = jsharding.cache_specs(jcfg, dp, "model")
        gg, ge = sharding.cache_specs(cfg, dp, "model")
        assert [{k: _tup(v) for k, v in d.items()} for d in wg] == list(gg)
        assert [{k: _tup(v) for k, v in d.items()} for d in we] == list(ge)


def _compare_leaf(got, want, what):
    assert tuple(got.shape) == tuple(want.shape), (what, got.shape, want.shape)
    assert got.dtype == _dtype(want.dtype), (what, got.dtype, want.dtype)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_abstract_shapes_match_reference(arch):
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    port, ref = _port_params(arch), _ref_params(arch)
    refp = _by_path(ref)
    assert {tuple(sharding.reference_path(cfg, n, t.shape)[0])
            for n, t in port.items()} == set(refp)
    for name, t in port.items():
        parts, shape, stacked = sharding.reference_path(cfg, name, t.shape)
        w = refp[tuple(parts)]
        assert shape == tuple(w.shape) and t.dtype == _dtype(w.dtype), name
        assert isinstance(t, torch._subclasses.fake_tensor.FakeTensor)
    opt = specs.abstract_opt_state(port)
    jopt = _by_path(jspecs.abstract_opt_state(ref))
    for key in ("m", "v"):
        for name, t in opt[key].items():
            parts, shape, _ = sharding.reference_path(cfg, name, t.shape)
            w = jopt[(key, *parts)]
            assert shape == tuple(w.shape) and t.dtype == _dtype(w.dtype)
    _compare_leaf(opt["count"], jopt[("count",)], "count")
    for sname in SHAPES:
        got = specs.input_specs(cfg, get_shape(sname))
        want = jspecs.input_specs(jcfg, jget_shape(sname))
        assert set(got) == set(want)
        for k in ("inputs", "targets", "pos"):
            if k in want:
                _compare_leaf(got[k], want[k], (sname, k))
        if "cache" in want:
            gw = _by_path(want["cache"])
            flat, _ = torch.utils._pytree.tree_flatten_with_path(got["cache"])
            gg = {tuple(str(getattr(e, "key", getattr(e, "idx", e)))
                        for e in p): l for p, l in flat}
            assert set(gg) == set(gw)
            for path, t in gg.items():
                _compare_leaf(t, gw[path], (sname, path))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_flops_and_memory_floor_match_reference(arch):
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    for sname in SHAPES:
        for n_chips in (8, 256, 512):
            assert specs.analytic_memory_floor(cfg, get_shape(sname), n_chips) \
                == jspecs.analytic_memory_floor(jcfg, jget_shape(sname),
                                                n_chips)
        assert specs.model_flops(cfg, get_shape(sname)) == \
            jspecs.model_flops(jcfg, jget_shape(sname))


def test_named_placements_on_a_fake_mesh():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import (dp_axes_of, make_mesh,
                                         make_production_mesh, pod_size_of)
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device_type="cpu")
    assert dp_axes_of(mesh) == ("pod", "data") and pod_size_of(mesh) == 4
    got = sharding.named(mesh, {"a": (("pod", "data"), None, "model"),
                                "b": (), "c": {"d": (None, "data")}})
    assert got == {"a": (Shard(0), Shard(0), Shard(2)),
                   "b": (Replicate(),) * 3,
                   "c": {"d": (Replicate(), Shard(1), Replicate())}}
    # a production mesh replaces the fake group of another size
    prod = make_production_mesh(device_type="cpu")
    assert tuple(prod.mesh.shape) == (16, 16) and pod_size_of(prod) == 256
    assert torch.distributed.get_world_size() == 256
    assert dp_axes_of(prod) == ("data",)
    with pytest.raises(ValueError, match="two dims"):
        sharding.named(mesh, ("data", "data"))
    torch.distributed.destroy_process_group()
    assert np.prod(prod.mesh.shape) == 256
