"""The port's sharding rules (``repro_torch.sharding.rules``) against the
reference's ``repro.sharding.rules``: parameter specs of all ten arch ids at
full width (the port's ``meta`` params against the reference's
``api.abstract_params()``) on the production and test mesh shapes, as
tests/test_runtime.py checks the reference's; the spec type, the rule
contexts, ``batch_spec`` and the DTensor placements a spec maps to.
Sharded execution is in tests/test_torch_cells.py."""

import functools

import pytest

import jax
from jax.sharding import PartitionSpec

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes; leave the cores to the other test workers

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.registry import build as jax_build  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models.convert import flatten  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.sharding import rules as trules  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402


def fake_mesh(shape):
    """The reference tests' FakeMesh: a mesh by its {axis: size} alone."""
    return type("FakeMesh", (), {"shape": dict(shape)})()


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2}}


@functools.lru_cache(maxsize=None)
def _reference_shapes(arch):
    return jax_build(jax_get_config(arch)).abstract_params()


@functools.lru_cache(maxsize=None)
def _port_shapes(arch):
    return build(get_config(arch), "meta").abstract_params()


def _jax_flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", None))) for k in kp): leaf
            for kp, leaf in leaves}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, mesh):
    """Every leaf's spec under the production rules of ``mesh``'s shape
    equals the reference's, entry by entry, and so does every leaf's shape;
    non-dividing axes are dropped alike (whisper's vocab 51865 on 16)."""
    fm = fake_mesh(MESHES[mesh])
    multi = "pod" in MESHES[mesh]
    with jrules.axis_rules(jrules.production_rules(multi, mesh=fm)):
        want = _jax_flat(jrules.param_specs(_reference_shapes(arch)))
    with trules.axis_rules(trules.production_rules(multi, mesh=fm)):
        got = trules.param_specs(_port_shapes(arch))
    flat = {path: spec for path, spec in _walk(got)}
    assert set(flat) == set(want)
    for path, spec in flat.items():
        assert isinstance(spec, trules.P)
        assert tuple(spec) == tuple(want[path]), path
    shapes = _jax_flat(_reference_shapes(arch))
    for path, leaf in flatten(_port_shapes(arch)).items():
        assert tuple(leaf.shape) == tuple(shapes[path].shape), path
        assert leaf.device.type == "meta"


def _walk(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (str(k),))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def test_p_normalises_as_partition_spec():
    """A one-axis tuple is the bare axis and an empty one None, as in
    ``PartitionSpec``, so specs compare equal entry by entry."""
    entries = (("data",), None, ("pod", "data"), ())
    assert tuple(trules.P(*entries)) == tuple(PartitionSpec(*entries))
    assert trules.P("data") == ("data",) and trules.P() == ()


def test_axis_rules_context_and_logical_spec():
    assert trules.current_rules() is None
    assert trules.logical_spec("batch", None) == (None, None)
    rules = trules.production_rules(False, shard_kv_heads=False)
    with trules.axis_rules(rules):
        assert trules.current_rules() is rules
        assert trules.logical_spec("batch", "model", "kv_heads", "nope") == (
            "data", "model", None, None)
        with trules.axis_rules({"batch": ("pod", "data")}):
            assert trules.logical_spec("batch") == (("pod", "data"),)
        assert trules.current_rules() is rules
    assert trules.current_rules() is None


@pytest.mark.parametrize("B", [1, 2, 6, 16, 32])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_spec_matches_reference(mesh, B):
    fm = fake_mesh(MESHES[mesh])
    assert tuple(trules.batch_spec(B, fm)) == tuple(jrules.batch_spec(B, fm))


def test_placements_of_specs():
    """One placement per mesh dim: ``Shard`` of the tensor dim that names
    it (a ("pod", "data") tuple shards one dim over both), ``Replicate``
    elsewhere and on mesh dims of size 1; a tuple out of the mesh's order
    shards over the same mesh dims (the reference's long-context cache
    spec, ("data", "model", "pod"))."""
    fm = fake_mesh(MESHES["2x16x16"])
    assert trules.placements(trules.P(("pod", "data"), None, "model"), fm) == (
        Shard(0), Shard(0), Shard(2))
    assert trules.placements(trules.P(None, "data"), fm) == (Replicate(), Shard(1), Replicate())
    assert trules.placements(trules.P(), fm) == (Replicate(),) * 3
    one = fake_mesh({"data": 1, "model": 2})
    assert trules.placements(trules.P("data", "model"), one) == (Replicate(), Shard(1))
    assert trules.placements(trules.P(("data", "pod")), fm) == (Shard(0), Shard(0), Replicate())
    assert trules.placements(trules.P(None, ("data", "model", "pod")), fm) == (Shard(1),) * 3


def test_logical_constraint_is_identity_without_rules_or_dtensor():
    x = torch.ones(4, 8)
    assert trules.logical_constraint(x, "batch", "model") is x
    with trules.axis_rules(trules.production_rules(False)):
        assert trules.logical_constraint(x, "batch", "model") is x


def test_production_mesh_needs_its_world():
    """The 16x16 and 2x16x16 meshes need 256 / 512 ranks; on a smaller world
    (none here) they raise naming the dry run that builds them on a fake
    process group."""
    for multi in (False, True):
        with pytest.raises(RuntimeError, match="repro_torch.launch.dryrun"):
            tmesh.make_production_mesh(multi_pod=multi, device_type="cpu")
    with pytest.raises(RuntimeError, match="process group of 4"):
        tmesh.make_test_mesh(2, 2, device_type="cpu")
