"""The port's LM sharding layer against the JAX package's.

``repro_torch.sharding`` resolves the JAX package's logical-axis rules
to specs (plain tuples, equal to ``tuple(PartitionSpec)``) and
``DTensor`` placements.  Here, for every architecture at full width, on
the 2×2, 16×16 and 2×16×16 meshes: every parameter's spec and per-device
shape equals JAX's ``param_shardings``, every input of the four shape
sets JAX's ``batch_shardings``, the decode caches JAX's
``cache_shardings``; the abstract values (``abstract_params``,
``logical_axes``, ``input_specs``, ``abstract_opt_state``) match JAX's
shapes, dtypes and tree order; and ``tests/test_sharding.py``'s cases
hold on the port.  The JAX side is a ``Mesh`` of the one CPU device
repeated (as ``tests/test_sharding.py`` builds it); the port's is a
``MeshShape`` — specs need no process group.  Nothing is compiled.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import repro.models as JM
from repro.configs import ARCHS, get_config as jget
from repro.sharding import (batch_shardings as jbatch,
                            cache_shardings as jcache,
                            param_shardings as jparam,
                            resolve_spec as jresolve)
from repro.train.optimizer import abstract_opt_state as jabstract_opt
from repro_torch import models as M
from repro_torch.configs import get_config
from repro_torch.sharding import (LOGICAL_RULES, MeshShape, Sharding,
                                  batch_shardings, cache_shardings,
                                  data_axes, param_shardings, placements,
                                  resolve_spec)
from repro_torch.train.optimizer import OptState, abstract_opt_state
from repro_torch.train.tree import tree_items

MESHES = {"2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def jmesh(name):
    shape, names = MESHES[name]
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices() * n)[:n].reshape(shape), names)


def tmesh(name):
    return MeshShape(*MESHES[name])


def jitems(tree):
    """(path, leaf) of a JAX tree, in its flatten order."""
    return [(tuple(getattr(k, "key", getattr(k, "name", k)) for k in kp), x)
            for kp, x in jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: isinstance(x, NamedSharding))]


def titems(tree):
    return [(tuple(k.lstrip(".") for k in path), x)
            for path, x in tree_items(tree)]


def hold(port_tree, jax_tree, shapes=None):
    """Same paths in the same order; each port spec equal to JAX's, and
    its per-device shape too where ``shapes`` (path: shape) is given."""
    got, want = titems(port_tree), jitems(jax_tree)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, sh), (_, jsh) in zip(got, want):
        assert isinstance(sh, Sharding)
        assert sh.spec == tuple(jsh.spec), path
        if shapes is not None:
            assert sh.shard_shape(shapes[path]) == jsh.shard_shape(
                shapes[path]), path


# ---------------------------------------------------------------------
# full width, every arch, every mesh
# ---------------------------------------------------------------------
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax(arch, mesh):
    """Every parameter leaf: ``resolve_spec`` (through
    ``param_shardings``) and the per-device shape equal JAX's."""
    cfg, jcfg = get_config(arch), jget(arch)
    pabs = M.abstract_params(cfg)
    sh = param_shardings(M.logical_axes(cfg), pabs, tmesh(mesh))
    jsh = jparam(JM.logical_axes(jcfg), JM.abstract_params(jcfg),
                 jmesh(mesh))
    shapes = {p: tuple(x.shape) for p, x in titems(pabs)}
    hold(sh, jsh, shapes)
    for path, axes in titems(M.logical_axes(cfg)):
        assert resolve_spec(axes, shapes[path], tmesh(mesh)) == tuple(
            jresolve(axes, shapes[path], jmesh(mesh))), path


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_equal_jax(arch, mesh):
    """``batch_shardings`` of every ``input_specs`` of the four shape
    sets (the decode sets' token and length too), and
    ``cache_shardings`` of the decode_32k and long_500k caches, equal
    JAX's, spec and per-device shape."""
    cfg, jcfg = get_config(arch), jget(arch)
    tm, jm = tmesh(mesh), jmesh(mesh)
    for shape in SHAPES:
        spec, jspec = M.input_specs(cfg, shape), JM.input_specs(jcfg, shape)
        if "cache" in spec:
            cache = spec.pop("cache")
            jc = jspec.pop("cache")
            hold(cache_shardings(cache, tm, cfg), jcache(jc, jm, jcfg),
                 {p: tuple(x.shape) for p, x in titems(cache)})
        hold(batch_shardings(spec, tm), jbatch(jspec, jm),
             {p: tuple(x.shape) for p, x in titems(spec)})


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_cache_specs_with_shard_state_dim_equal_jax(mesh):
    """xLSTM's recurrent states with ``shard_state_dim`` (the last
    feature dim over ``model`` in place of the heads): JAX's specs, at
    decode_32k and long_500k."""
    import dataclasses

    cfg = dataclasses.replace(get_config("xlstm_1_3b"), shard_state_dim=True)
    jcfg = dataclasses.replace(jget("xlstm_1_3b"), shard_state_dim=True)
    for shape in ("decode_32k", "long_500k"):
        cache = M.input_specs(cfg, shape)["cache"]
        sh = cache_shardings(cache, tmesh(mesh), cfg)
        hold(sh, jcache(JM.input_specs(jcfg, shape)["cache"], jmesh(mesh),
                        jcfg), {p: tuple(x.shape) for p, x in titems(cache)})
        assert sh["mlstm_S"].spec[-1] == "model"


_JDT = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32,
        jnp.int32: torch.int32}


def same_abstract(port_tree, jax_tree):
    got = titems(port_tree)
    want = [(tuple(getattr(k, "key", getattr(k, "name", k)) for k in kp), x)
            for kp, x in jax.tree_util.tree_leaves_with_path(jax_tree)]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, x), (_, jx) in zip(got, want):
        assert x.device.type == "meta", path
        assert tuple(x.shape) == tuple(jx.shape), path
        assert x.dtype == _JDT[jx.dtype.type], path


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_values_match_jax(arch):
    """``abstract_params`` (bf16 and f32), ``logical_axes``,
    ``input_specs`` of every shape set and ``abstract_opt_state``: JAX's
    shapes, dtypes and flatten order, as meta tensors; the spec tree in
    ``param_specs``' insertion order, as JAX's ``_map_specs`` keeps it."""
    cfg, jcfg = get_config(arch), jget(arch)
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                    (torch.float32, jnp.float32)):
        same_abstract(M.abstract_params(cfg, dt),
                      JM.abstract_params(jcfg, jdt))
    axes, jaxes = M.logical_axes(cfg), JM.logical_axes(jcfg)
    flat = lambda t, pre=(): [x for k, v in t.items() for x in (
        flat(v, pre + (k,)) if isinstance(v, dict) else [(pre + (k,), v)])]
    assert flat(axes) == flat(jaxes)
    for shape in SHAPES:
        same_abstract(M.input_specs(cfg, shape),
                      JM.input_specs(jcfg, shape))
        same_abstract(M.input_specs(cfg, shape, batch=3, seq=40),
                      JM.input_specs(jcfg, shape, batch=3, seq=40))
    pabs = M.abstract_params(cfg)
    opt = abstract_opt_state(pabs)
    assert isinstance(opt, OptState)
    same_abstract(opt, jabstract_opt(JM.abstract_params(jcfg)))


# ---------------------------------------------------------------------
# tests/test_sharding.py, case for case, on the port
# ---------------------------------------------------------------------
M22 = MeshShape((2, 2), ("data", "model"))


def test_resolve_basic():
    assert resolve_spec(("embed", "heads"), (64, 64), M22) == (
        "data", "model")


def test_resolve_divisibility_fallback():
    # 1 kv head cannot shard over model=2 -> replicated (gemma MQA case)
    assert resolve_spec(("embed", "kv"), (64, 1), M22) == ("data",)
    # odd dim cannot shard
    assert resolve_spec(("embed", "mlp"), (63, 64), M22) == (None, "model")


def test_resolve_no_axis_reuse():
    # both want "model"; only the first gets it
    assert resolve_spec(("heads", "mlp"), (64, 64), M22) == ("model",)


def test_layers_never_sharded():
    assert resolve_spec(("layers", "embed", "heads"), (22, 64, 64),
                        M22) == (None, "data", "model")
    assert LOGICAL_RULES["layers"] is None


def test_param_shardings_cover_all_archs():
    for arch in ("tinyllama_1_1b", "deepseek_v2_236b", "xlstm_1_3b",
                 "zamba2_7b", "whisper_large_v3"):
        cfg = get_config(arch)
        pabs = M.abstract_params(cfg)
        sh = param_shardings(M.logical_axes(cfg), pabs, M22)
        assert len(titems(sh)) == len(titems(pabs))


def test_batch_shardings():
    sh = batch_shardings(M.input_specs(get_config("tinyllama_1_1b"),
                                       "train_4k"), M22)
    assert sh["tokens"].spec[0] == "data"


def test_cache_shardings_decode():
    cfg = get_config("tinyllama_1_1b")
    cache = M.input_specs(cfg, "decode_32k", batch=128, seq=1024)["cache"]
    sh = cache_shardings(cache, M22, cfg)
    # [L, B, KV, S, hd]: batch over data, seq over model
    assert sh["k"].spec[1] == "data"
    assert sh["k"].spec[3] == "model"


def test_cache_shardings_long_context_batch1():
    cfg = get_config("zamba2_7b")
    cache = M.input_specs(cfg, "long_500k", batch=1, seq=2048)["cache"]
    spec = cache_shardings(cache, M22, cfg)["attn_k"].spec
    # batch=1 cannot shard; attn cache seq still shards over model
    assert spec[1] is None and spec[3] == "model"


# ---------------------------------------------------------------------
# placements: a spec as DTensor's Shard / Replicate
# ---------------------------------------------------------------------
def test_placements_and_shard_shape():
    """One placement a mesh dim; a dim over ("pod", "data") is
    ``Shard(d)`` on both, and its shard shape JAX's; the data axes of
    each mesh; the scalar's empty spec replicates."""
    from torch.distributed.tensor import Replicate, Shard

    m3 = tmesh("2x16x16")
    spec = (("pod", "data"), None, "model")
    assert placements(spec, m3) == [Shard(0), Shard(0), Shard(2)]
    assert placements((None, "data"), M22) == [Shard(1), Replicate()]
    assert placements((), m3) == [Replicate()] * 3
    jsh = NamedSharding(jmesh("2x16x16"), P(*spec))
    for shape in ((64, 3, 32), (32, 5, 16)):
        assert Sharding(m3, spec).shard_shape(shape) == jsh.shard_shape(shape)
    assert data_axes(m3) == ("pod", "data") and data_axes(M22) == ("data",)


@pytest.mark.parametrize("spec,match", [
    ((("data", "pod"),), "order"),       # DTensor splits in mesh order
    (("data", "data"), "twice"),
    (("expert",), "not an axis"),
])
def test_placements_refuse(spec, match):
    with pytest.raises(ValueError, match=match):
        placements(spec, tmesh("2x16x16"))


def test_shard_shape_refuses_a_dim_that_does_not_divide():
    with pytest.raises(ValueError, match="divide"):
        Sharding(M22, ("data",)).shard_shape((3, 4))
