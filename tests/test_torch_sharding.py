"""The port's sharding rules against the JAX package's, spec for spec.

One JAX subprocess (512 host devices, so the production meshes exist)
computes the reference's specs for the 11 registry configs at full size on
(16, 16), (2, 16, 16), (2, 4) and (2, 2, 2): ``param_shardings``,
``opt_state_shardings``, and ``batch_shardings`` / ``cache_shardings``
(plain and ``seq_shard``) on ``input_specs`` for train_4k and decode_32k;
also ``abstract_params``' shapes and dtypes, and the index map of a few
shardings.  The port computes the same from a ``MeshShape`` (no process
group) and its one-dict-per-layer layout: each per-layer spec must be the
reference's stacked spec without its (unsharded) stacking entry.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from repro_torch.configs import REGISTRY, SHAPES  # noqa: E402
from repro_torch.launch import input_specs as IS  # noqa: E402
from repro_torch.launch.mesh import MeshShape, production_mesh_shape  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import AdamWConfig, init_opt_state  # noqa: E402
from repro_torch.parallel import sharding as SH  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": production_mesh_shape(),
          "2x16x16": production_mesh_shape(multi_pod=True),
          "2x4": MeshShape(("data", "model"), (2, 4)),
          "2x2x2": MeshShape(("pod", "data", "model"), (2, 2, 2))}
INDEX_CASES = [  # (mesh, spec, shape) whose per-device pieces are compared
    ("2x2x2", (("pod", "data"), "model"), (8, 4)),
    ("2x2x2", ("model", ("pod", "data")), (6, 8)),
    ("2x4", (None, ("data", "model")), (3, 16)),
    ("2x4", ("model", "data"), (8, 6)),
]

REFERENCE = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import jax, jax.experimental, numpy as np
    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = jax.enable_x64
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import REGISTRY, SHAPES
    from repro.launch import input_specs as IS
    from repro.models import model as M
    from repro.optim import AdamWConfig, init_opt_state
    from repro.parallel import sharding as SH

    MESHES = {"16x16": ((16, 16), ("data", "model")),
              "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
              "2x4": ((2, 4), ("data", "model")),
              "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
    devs = jax.devices()
    meshes = {k: Mesh(np.array(devs[:int(np.prod(s))]).reshape(s), a)
              for k, (s, a) in MESHES.items()}

    def dump(tree):
        leaves = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
        return {"/".join(SH._path_names(p)):
                [list(e) if isinstance(e, tuple) else e for e in s.spec]
                for p, s in leaves}

    res = {}
    for name, cfg in REGISTRY.items():
        ap = M.abstract_params(cfg)
        aopt = jax.eval_shape(lambda p: init_opt_state(p, AdamWConfig()), ap)
        r = {"abstract": {"/".join(SH._path_names(p)): [list(x.shape), str(x.dtype)]
                          for p, x in jax.tree_util.tree_flatten_with_path(ap)[0]}}
        for mname, m in meshes.items():
            ps = SH.param_shardings(m, ap)
            r[f"params/{mname}"] = dump(ps)
            r[f"opt/{mname}"] = dump(SH.opt_state_shardings(m, aopt, ps))
            for sh in ("train_4k", "decode_32k"):
                specs = IS.input_specs(cfg, SHAPES[sh])
                batch = specs.get("batch", {"tokens": specs.get("tokens")})
                for seq in (False, True):
                    r[f"batch/{sh}/{seq}/{mname}"] = dump(
                        SH.batch_shardings(m, batch, seq_shard=seq))
                    if "cache" in specs:
                        r[f"cache/{sh}/{seq}/{mname}"] = dump(
                            SH.cache_shardings(m, specs["cache"], seq_shard=seq))
        res[name] = r
    index = []
    for mname, spec, shape in json.loads(sys.argv[1]):
        m = meshes[mname]
        spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
        imap = NamedSharding(m, spec).devices_indices_map(tuple(shape))
        index.append([[[s.start or 0, shape[i] if s.stop is None else s.stop]
                       for i, s in enumerate(imap[d])] for d in m.devices.flat])
    res["__index__"] = index
    json.dump(res, sys.stdout)
""")


@pytest.fixture(scope="module")
def ref():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", REFERENCE, json.dumps(INDEX_CASES)],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout)


_STACKS = ("enc_stack", "dec_stack", "self", "xkv")


def _items(tree, path=()):
    """(the reference's key, stacked?, leaf) of every leaf of a port tree:
    a layer's index (under "segments"' segment, or in an encoder-decoder
    stack) is dropped from the key, its leaf stacked there."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == "segments" and isinstance(v, list):
                for i, seg in enumerate(v):
                    for layer in seg:
                        for rp, _st, leaf in _items(layer):
                            yield path + (k, str(i)) + rp, True, leaf
            elif k in _STACKS and isinstance(v, list):
                for layer in v:
                    for rp, _st, leaf in _items(layer):
                        yield path + (k,) + rp, True, leaf
            else:
                yield from _items(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _items(v, path + (str(i),))
    else:
        yield path, False, tree


def _spec(s):
    return [list(e) if isinstance(e, tuple) else e for e in s.spec]


def _same(port_tree, want: dict, what) -> int:
    seen, n = set(), 0
    for rp, stacked, sh in _items(port_tree):
        key = "/".join(rp)
        seen.add(key)
        expect = want[key]
        if stacked:
            assert expect[0] is None, (what, key, expect)
            expect = expect[1:]
        assert _spec(sh) == expect, (what, key, _spec(sh), expect)
        n += 1
    assert seen == set(want), (what, sorted(seen ^ set(want))[:5])
    return n


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_param_and_opt_state_specs_match_the_reference(ref, arch):
    cfg = REGISTRY[arch]
    ap = M.abstract_params(cfg)
    aopt = init_opt_state(ap, AdamWConfig())
    for mname, mesh in MESHES.items():
        ps = SH.param_shardings(mesh, ap)
        assert _same(ps, ref[arch][f"params/{mname}"], (arch, mname, "params"))
        _same(SH.opt_state_shardings(mesh, aopt, ps), ref[arch][f"opt/{mname}"],
              (arch, mname, "opt"))


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_batch_and_cache_specs_match_the_reference(ref, arch):
    cfg = REGISTRY[arch]
    for sh in ("train_4k", "decode_32k"):
        specs = IS.input_specs(cfg, SHAPES[sh])
        batch = specs.get("batch", {"tokens": specs.get("tokens")})
        for mname, mesh in MESHES.items():
            for seq in (False, True):
                what = (arch, sh, seq, mname)
                _same(SH.batch_shardings(mesh, batch, seq_shard=seq),
                      ref[arch][f"batch/{sh}/{seq}/{mname}"], what + ("batch",))
                if "cache" in specs:
                    _same(SH.cache_shardings(mesh, specs["cache"], seq_shard=seq),
                          ref[arch][f"cache/{sh}/{seq}/{mname}"], what + ("cache",))


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_abstract_params_match_the_reference(ref, arch):
    ap = M.abstract_params(REGISTRY[arch])
    want = ref[arch]["abstract"]
    counts, stacks = {}, {}
    for rp, stacked, leaf in _items(ap):
        key = "/".join(rp)
        shape, dtype = want[key]
        assert leaf.device.type == "meta"
        assert str(leaf.dtype).removeprefix("torch.") == dtype, (key, leaf.dtype, dtype)
        assert list(leaf.shape) == (shape[1:] if stacked else shape), (key, leaf.shape, shape)
        counts[key] = counts.get(key, 0) + 1
        stacks[key] = stacked
    assert set(counts) == set(want)
    for key, n in counts.items():  # one port leaf per stacked layer
        assert n == (want[key][0][0] if stacks[key] else 1), (key, n)


def test_a_rule_that_would_shard_the_stacking_axis_raises():
    # A (3, 5) projection cannot host 2-way data or 4-way model sharding, so
    # repair_spec re-places both on the largest dimension of the stacked
    # (64, 3, 5) shape: the layer axis, which the port does not have.
    layer = {"sub0": {"attn": {"wq": torch.empty((3, 5), device="meta")}}}
    tree = {"segments": [[layer] * 64]}
    with pytest.raises(SH.StackedAxisSharded):
        SH.param_shardings(MESHES["2x4"], tree)


@pytest.mark.parametrize("case", range(len(INDEX_CASES)))
def test_pieces_are_where_the_reference_puts_them(ref, case):
    mname, spec, shape = INDEX_CASES[case]
    mesh = MESHES[mname]
    sh = SH.NamedSharding(mesh, SH.P(*spec))
    grid = torch.arange(mesh.size).reshape(mesh.sizes)
    for rank, want in enumerate(ref["__index__"][case]):
        coord = dict(zip(mesh.axis_names, (int(c) for c in (grid == rank).nonzero()[0])))
        got = [[s.start, s.stop] for s in SH.local_slices(sh, shape, coord)]
        assert got == want, (mname, spec, rank, got, want)


def test_placements_follow_the_mesh_dimensions():
    from torch.distributed.tensor import Replicate, Shard

    sh = SH.NamedSharding(MESHES["2x2x2"], SH.P(("pod", "data"), "model"))
    assert sh.placements == (Shard(0), Shard(0), Shard(1))
    assert SH.NamedSharding(MESHES["2x4"], SH.P(None)).placements == (Replicate(),) * 2
    with pytest.raises(ValueError):
        SH.NamedSharding(MESHES["2x4"], SH.P(("model", "data"))).placements
