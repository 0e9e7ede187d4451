"""The port's sharding vocabulary and mesh helpers against the reference's.

``repro_torch.launch.sharding.rules_for`` against ``repro.launch.sharding``'s
for every arch × shape on fake meshes of 16×16, 2×16×16 and 1×1 (the
reference's three ``test_rules_*`` cases mirrored as cases of one test);
every parameter's, batch input's and cache leaf's resolved spec equal to
the reference's ``PartitionSpec`` as a tuple; ``cache_logical`` equal; the
shape trees (``input_specs``, ``cache_specs``, ``param_shapes``,
``opt_shapes``) equal in shape and dtype for every cell, as meta tensors;
``model_flops_estimate`` equal for every cell.  And the mesh helpers: a
mesh with more devices than are present raises, naming the count.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from repro.configs import base as ref_base  # noqa: E402
from repro.launch import roofline as ref_roofline  # noqa: E402
from repro.launch import sharding as ref_shd  # noqa: E402
from repro.models import kvcache as ref_kvcache  # noqa: E402
from repro.models.common import DEFAULT_RULES as REF_DEFAULT_RULES  # noqa: E402
from repro.models.common import SP_RULES as REF_SP_RULES  # noqa: E402
from repro.models.common import ParamSpec as RefParamSpec  # noqa: E402
from repro.models.common import logical_spec as ref_logical_spec  # noqa: E402
from repro.models.transformer import param_specs as ref_param_specs  # noqa: E402

from repro_torch.configs import base  # noqa: E402
from repro_torch.launch import roofline, sharding  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    Mesh,
    make_host_mesh,
    make_mesh,
    make_production_mesh,
)
from repro_torch.models import kvcache  # noqa: E402
from repro_torch.models.common import (  # noqa: E402
    DEFAULT_RULES,
    SP_RULES,
    activation_rules,
    constrain,
    current_mesh,
    logical_spec,
    tree_leaves,
    tree_logical,
)
from repro_torch.models.transformer import param_specs  # noqa: E402

ARCHS = base.ARCH_IDS
CELLS = [(a, s) for a in ARCHS for s in base.SHAPES]


class FakeMesh:
    def __init__(self, **axes):
        self.shape = axes
        self.axis_names = tuple(axes)


MESHES = {
    "16x16": dict(data=16, model=16),
    "2x16x16": dict(pod=2, data=16, model=16),
    "1x1": dict(data=1, model=1),
}


def _spec_tuple(p) -> tuple:
    return tuple(p)


def _dtype_name(t) -> str:
    if isinstance(t, torch.Tensor):
        return str(t.dtype).split(".")[-1]
    return np.dtype(t.dtype).name


def _same_shape_tree(port_leaves, ref_leaves):
    assert len(port_leaves) == len(ref_leaves)
    for t, sd in zip(port_leaves, ref_leaves):
        assert t.is_meta
        assert tuple(t.shape) == tuple(sd.shape)
        assert _dtype_name(t) == _dtype_name(sd)


def test_rule_tables_match_reference():
    assert DEFAULT_RULES == REF_DEFAULT_RULES and SP_RULES == REF_SP_RULES
    axes = ("batch", "seq", None, "heads", "cache_batch")
    for rules in (None, SP_RULES):
        assert logical_spec(axes, rules) == _spec_tuple(ref_logical_spec(axes, rules))


@pytest.mark.parametrize("mesh", list(MESHES), ids=str)
def test_rules_for_matches_reference(mesh):
    fake = FakeMesh(**MESHES[mesh])
    for arch, shape in CELLS:
        got = sharding.rules_for(base.get_config(arch), base.SHAPES[shape], fake)
        want = ref_shd.rules_for(ref_base.get_config(arch), ref_base.SHAPES[shape], fake)
        assert got == want, (arch, shape)


@pytest.mark.parametrize("case", ["divisibility", "decode_cache", "degenerate_batch"])
def test_rules_cases(case):
    """tests/test_distribution.py's three ``test_rules_*`` cases on the port."""
    mesh = FakeMesh(data=16, model=16)
    rules_for = sharding.rules_for
    if case == "divisibility":
        rules = rules_for(base.get_config("llama3_2_3b"), base.SHAPES["train_4k"], mesh)
        assert rules["heads"] is None  # 24 heads: not divisible by 16
        assert rules["ff"] == "model"  # 8192 % 16 == 0
        assert rules["batch"] == ("data",)
        rules2 = rules_for(base.get_config("glm4_9b"), base.SHAPES["train_4k"], mesh)
        assert rules2["heads"] == "model"
    elif case == "decode_cache":
        r = rules_for(base.get_config("glm4_9b"), base.SHAPES["decode_32k"], mesh)
        assert r["cache_heads"] is None and r["cache_seq"] == "model"  # kv=2
        r2 = rules_for(base.get_config("gemma_7b"), base.SHAPES["decode_32k"], mesh)
        assert r2["cache_heads"] == "model"  # kv=16
    else:
        rules = rules_for(base.get_config("recurrentgemma_2b"), base.SHAPES["long_500k"], mesh)
        assert rules["batch"] is None


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_resolve_as_reference(arch):
    """Every parameter's, input's, cache leaf's and the logits' resolved
    spec, leaf by leaf in the reference's flatten order, on the 16×16 and
    2×16×16 meshes for every applicable shape; the logical trees equal."""
    cfg, ref_cfg = base.get_config(arch), ref_base.get_config(arch)
    is_ref_spec = lambda x: isinstance(x, RefParamSpec)  # noqa: E731
    ref_logical = jax.tree.leaves(
        jax.tree.map(lambda s: s.logical, ref_param_specs(ref_cfg), is_leaf=is_ref_spec),
        is_leaf=lambda x: isinstance(x, tuple),
    )
    port_logical = tree_leaves(tree_logical(param_specs(cfg)),
                               is_leaf=lambda x: isinstance(x, tuple))
    assert port_logical == ref_logical
    assert kvcache.cache_logical(cfg) == ref_kvcache.cache_logical(ref_cfg)
    for mesh in (FakeMesh(**MESHES["16x16"]), FakeMesh(**MESHES["2x16x16"])):
        for name, shape in base.SHAPES.items():
            rules = sharding.rules_for(cfg, shape, mesh)
            ref_rules = ref_shd.rules_for(ref_cfg, ref_base.SHAPES[name], mesh)
            got = [s.spec for s in tree_leaves(sharding.param_shardings(cfg, mesh, rules),
                                               is_leaf=lambda x: isinstance(x, sharding.Sharding))]
            want = [_spec_tuple(ref_logical_spec(ax, ref_rules)) for ax in ref_logical]
            assert got == want
            batch = sharding.batch_shardings(cfg, shape, mesh, rules)
            ref_batch = _ref_batch_specs(ref_cfg, ref_base.SHAPES[name], ref_rules)
            assert {k: v.spec for k, v in batch.items()} == ref_batch
            cache = tree_leaves(sharding.cache_shardings(cfg, shape, mesh, rules),
                                is_leaf=lambda x: isinstance(x, sharding.Sharding))
            ref_cache_logical = jax.tree.leaves(
                ref_kvcache.cache_logical(ref_cfg), is_leaf=lambda x: isinstance(x, tuple))
            assert [c.spec for c in cache] == [
                _spec_tuple(ref_logical_spec(ax, ref_rules)) for ax in ref_cache_logical]
            logits = sharding.logits_sharding(cfg, mesh, rules)
            assert logits.spec == tuple(P(ref_rules["batch"], None, ref_rules["vocab"]))


def _ref_batch_specs(ref_cfg, shape, rules) -> dict:
    """The specs of the reference's ``batch_shardings`` as tuples (built
    there as ``NamedSharding``s over a real mesh; here its ``PartitionSpec``s
    from the same rule)."""
    out = {}
    for name, sd in ref_base.input_specs(ref_cfg, shape).items():
        if sd.ndim == 3:
            out[name] = tuple(P(rules["batch"], rules["seq"], None))
        elif sd.ndim == 2:
            out[name] = tuple(P(rules["batch"], rules["seq"]))
        else:
            out[name] = tuple(P(rules["batch"]))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_shape_trees_match_reference(arch):
    """input_specs, cache_specs/cache_shapes, param_shapes and opt_shapes:
    meta tensors of the reference's shapes and dtypes, leaf for leaf, for
    every shape; model_flops_estimate equal for every cell."""
    cfg, ref_cfg = base.get_config(arch), ref_base.get_config(arch)
    _same_shape_tree(tree_leaves(sharding.param_shapes(cfg)),
                     jax.tree.leaves(ref_shd.param_shapes(ref_cfg)))
    opt, ref_opt = sharding.opt_shapes(cfg), ref_shd.opt_shapes(ref_cfg, None)
    _same_shape_tree([opt.step, *tree_leaves(opt.m), *tree_leaves(opt.v)],
                     [ref_opt.step, *jax.tree.leaves(ref_opt.m), *jax.tree.leaves(ref_opt.v)])
    for name, shape in base.SHAPES.items():
        ref_shape = ref_base.SHAPES[name]
        got, want = base.input_specs(cfg, shape), ref_base.input_specs(ref_cfg, ref_shape)
        assert list(got) == list(want)
        _same_shape_tree(list(got.values()), list(want.values()))
        _same_shape_tree(tree_leaves(sharding.cache_shapes(cfg, shape)),
                         jax.tree.leaves(ref_shd.cache_shapes(ref_cfg, ref_shape)))
        assert roofline.model_flops_estimate(cfg, shape) == \
            ref_roofline.model_flops_estimate(ref_cfg, ref_shape)


def test_per_device_bytes_divide_by_the_mesh_axes():
    """A spec's per-device shape divides each dim by the sizes of the axes
    it names; on the 1×1 mesh it is the whole shape."""
    fake = FakeMesh(pod=2, data=16, model=16)
    s = sharding.Sharding(fake, (("pod", "data"), None, "model"))
    assert s.shard_shape((64, 3, 32)) == (2, 3, 2)
    t = torch.empty((64, 3, 32), dtype=torch.bfloat16, device="meta")
    assert s.device_bytes(t) == 2 * 3 * 2 * 2
    one = sharding.Sharding(make_host_mesh(device="cpu"), (("data",), None, "model"))
    assert one.shard_shape((64, 3, 32)) == (64, 3, 32)
    with pytest.raises(ValueError, match="does not divide"):
        s.shard_shape((3, 3, 32))


def test_mesh_helpers():
    """The port's meshes hold the devices that are present: a 1×1 host mesh
    and a one-axis engine mesh build; a mesh of more devices raises, and
    the production meshes name the 256/512 devices they need and the count
    found."""
    mesh = make_host_mesh(device="cpu")
    assert isinstance(mesh, Mesh) and mesh.shape == {"data": 1, "model": 1}
    assert mesh.axis_names == ("data", "model") and mesh.size == 1
    assert make_mesh((1,), ("nodes",), device="cpu").axis_names == ("nodes",)
    with pytest.raises(RuntimeError, match="needs 2 devices, found 1"):
        make_host_mesh(2, 1, device="cpu")
    with pytest.raises(RuntimeError, match=r"needs 256 devices, found 1"):
        make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match=r"needs 512 devices, found 1"):
        make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError, match="differ in length"):
        make_mesh((1, 1), ("nodes",), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_host_mesh()


def test_activation_rules_carry_the_mesh_and_constrain():
    mesh = make_host_mesh(device="cpu")
    x = torch.randn(2, 3)
    assert current_mesh() is None and constrain(x, "batch", None) is x
    with activation_rules(DEFAULT_RULES, mesh=mesh):
        assert current_mesh() is mesh
        assert constrain(x, "batch", "embed") is x
        with pytest.raises(ValueError, match="2-D"):
            constrain(x, "batch")
    with activation_rules(DEFAULT_RULES, mesh=FakeMesh(data=2, model=1)):
        with pytest.raises(ValueError, match="more than one device"):
            constrain(x, "batch", None)
    assert current_mesh() is None

