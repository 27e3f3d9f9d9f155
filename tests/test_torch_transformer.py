"""The port's transformer serving slice against the JAX package, on the CPU.

* ``repro_torch.configs`` equals ``repro.configs`` field by field;
* ``transformer_block_ir`` / ``lm_ir`` are layer-equal to the reference's;
* ``plan_model`` gives bit-identical bandwidth verdicts and engine for all
  11 configs, with tiles that fit a Hopper block;
* one parameter tree from ``repro.models.model.init_params`` goes, via
  ``params_from_jax``, through the port's model: uncached forward, prefill
  and greedy decode agree with the JAX model (float32, 1e-4, the tolerance
  of tests/test_models.py) and give the same token ids;
* ``serve.main`` runs the reduced config to the end on the CPU.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as r_configs  # noqa: E402
from repro.core import ir as r_ir  # noqa: E402
from repro.core import planner as r_planner  # noqa: E402
from repro.models import model as r_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import ir, planner  # noqa: E402
from repro_torch.kernels import fused_attention, fused_conv, fused_mlp, ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

NAMES = sorted(r_configs.REGISTRY)
SHAPE_NAMES = sorted(r_configs.SHAPES)
SMEM_LIMIT = 232_448  # shared memory one Hopper block may opt in to
TOL = 1e-4  # float32 logits, port vs reference: tests/test_models.py


# ---------------------------------------------------------------------------
# configs, IR, planner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_config_equals_the_reference_field_by_field(name):
    ref_cfg = r_configs.REGISTRY[name]
    cfg = configs.REGISTRY[name]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert dataclasses.asdict(configs.scaled_down(cfg)) == \
        dataclasses.asdict(r_configs.scaled_down(ref_cfg))
    assert cfg.param_counts() == ref_cfg.param_counts()
    assert configs.supported_shapes(name) == r_configs.supported_shapes(name)
    for shape in SHAPE_NAMES:
        assert dataclasses.asdict(configs.run_config(name, shape)) == \
            dataclasses.asdict(r_configs.run_config(name, shape))


def test_registry_aliases_and_shapes_equal_the_reference():
    assert list(configs.REGISTRY) == list(r_configs.REGISTRY)
    assert configs.ALIASES == r_configs.ALIASES
    for alias in configs.ALIASES:
        assert configs.resolve(alias).name == r_configs.resolve(alias).name
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in r_configs.SHAPES.items()}
    assert configs.all_cells() == r_configs.all_cells()
    assert dataclasses.asdict(configs.RunConfig()) == dataclasses.asdict(r_configs.RunConfig())
    with pytest.raises(KeyError):
        configs.resolve("no-such-arch")


def _layers(net):
    return [dataclasses.astuple(layer) for layer in net.layers]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("seq", [128, 4096])
def test_transformer_block_ir_is_layer_equal(name, seq):
    cfg = configs.REGISTRY[name]
    kw = dict(name=name, d_model=cfg.d_model, n_heads=cfg.n_heads,
              n_kv_heads=cfg.n_kv_heads, d_ff=max(cfg.d_ff, 1), seq_len=seq,
              ffn_act=cfg.ffn_act, n_experts=cfg.n_experts, top_k=cfg.top_k)
    ours, theirs = ir.transformer_block_ir(**kw), r_ir.transformer_block_ir(**kw)
    assert ours.name == theirs.name and _layers(ours) == _layers(theirs)
    assert np.array_equal(ours.feature_matrix(), theirs.feature_matrix())


def test_transformer_block_ir_keeps_the_reference_head_width():
    # qwen3's head_dim is 128, but the block IR uses d_model // n_heads = 64
    cfg = configs.resolve("qwen3")
    net = ir.transformer_block_ir(name="q", d_model=cfg.d_model, n_heads=cfg.n_heads,
                                  n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff, seq_len=64)
    assert net.layers[1].n_out == 2 * cfg.n_kv_heads * (cfg.d_model // cfg.n_heads)


@pytest.mark.parametrize("repeat", [1, 3])
def test_lm_ir_is_layer_equal(repeat):
    kw = dict(name="lm", n_layers=4, d_model=256, n_heads=4, n_kv_heads=2,
              d_ff=512, seq_len=64, repeat=repeat)
    assert _layers(ir.lm_ir(**kw)) == _layers(r_ir.lm_ir(**kw))


@pytest.mark.parametrize("name", NAMES)
def test_plan_model_verdicts_are_bit_identical(name):
    cfg = configs.REGISTRY[name]
    ours = planner.plan_model(cfg, 4096)
    theirs = r_planner.plan_model(r_configs.REGISTRY[name], 4096)
    assert ours.bw_lbl_words == theirs.bw_lbl_words
    assert ours.bw_fused_words == theirs.bw_fused_words
    assert ours.search_engine == theirs.search_engine == "chain_dp"
    assert ours.bw_saving == theirs.bw_saving
    assert ours.use_fused_mlp == theirs.use_fused_mlp
    assert (ours.mamba_chunk, ours.mamba_block_d, ours.conv_block_c) == \
        (theirs.mamba_chunk, theirs.mamba_block_d, theirs.conv_block_c)
    # the tiles are the kernels' own, sized against Hopper shared memory
    assert ours.attn_vmem_bytes <= SMEM_LIMIT and ours.mlp_vmem_bytes <= SMEM_LIMIT
    assert (ours.mlp_block_m, ours.mlp_block_f) in fused_mlp.TILES
    assert ours.mlp_vmem_bytes == fused_mlp.smem_bytes(ours.mlp_block_m, ours.mlp_block_f)
    if ours.use_flash:
        assert (ours.attn_block_q, ours.attn_block_k) in fused_attention.TILES
        assert ours.attn_vmem_bytes == fused_attention.smem_bytes(
            ours.attn_block_q, ours.attn_block_k, cfg.resolved_head_dim)
    else:  # falcon-mamba: no attention sublayer to size
        assert "attn" not in "".join(cfg.layer_pattern)
        assert ours.attn_vmem_bytes == ours.attn_block_q == 0
    assert name in ours.describe()


def test_planner_keeps_only_tiles_that_fit():
    small = dataclasses.replace(planner.H100, smem_per_block_optin=100_000)
    plan = planner.plan_model(configs.resolve("qwen3"), 4096, small)
    assert plan.attn_vmem_bytes <= 100_000 and plan.mlp_vmem_bytes <= 100_000
    assert (plan.attn_block_q, plan.attn_block_k) == (64, 64)
    short = planner.plan_model(configs.resolve("qwen3"), 64)
    assert (short.attn_block_q, short.attn_block_k) == (64, 64)


def test_fused_conv_fn_takes_a_plan_with_the_built_block():
    plan = planner.plan_model(configs.resolve("qwen3"), 4096)
    assert plan.conv_block_c == fused_conv.BLOCK_C
    fn = ops.fused_conv_fn(plan, device="cpu")
    x = torch.ones(1, 4, 4, 3)
    y = fn(x, torch.ones(3, 3, 3, 8), torch.zeros(8), pool=True)
    assert y.shape == (1, 2, 2, 8)
    with pytest.raises(ValueError, match="conv_block_c = 32"):
        ops.fused_conv_fn(dataclasses.replace(plan, conv_block_c=32), device="cpu")


# ---------------------------------------------------------------------------
# the model against the JAX model
# ---------------------------------------------------------------------------


def _rc(name):
    rc = dataclasses.replace(r_configs.run_config(name, "decode_32k"), attn_chunk_kv=16)
    ours = dataclasses.replace(configs.run_config(name, "decode_32k"), attn_chunk_kv=16)
    return rc, ours


def _pair(cfg, seed):
    """The reference's parameters for ``cfg`` and the port's copy of them."""
    r_params = r_model.init_params(jax.random.key(seed), _ref_cfg(cfg))
    tree = jax.tree.map(np.asarray, r_params)
    return r_params, T.params_from_jax(tree)


def _ref_cfg(cfg):
    """The reference's ModelConfig with the same fields as ``cfg``."""
    return r_configs.ModelConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("arch", ["qwen3", "gemma3", "granite", "phi3", "internvl2"])
def test_uncached_forward_matches_the_jax_model(arch):
    cfg = configs.scaled_down(configs.resolve(arch))
    r_rc, rc = _rc(cfg.name)
    r_params, params = _pair(cfg, 1)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (2, 24))
    r_batch, batch = {"tokens": jnp.asarray(tokens)}, {"tokens": torch.from_numpy(tokens)}
    if cfg.frontend:
        fe = rng.standard_normal((2, cfg.frontend_len, cfg.d_model), dtype=np.float32)
        r_batch["frontend"], batch["frontend"] = jnp.asarray(fe), torch.from_numpy(fe)
    want, _, _ = r_model.forward(r_params, _ref_cfg(cfg), r_rc, r_batch)
    got, cache, _ = M.forward(params, cfg, rc, batch)
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("arch", ["qwen3", "granite", "phi3", "internvl2"])
def test_prefill_and_greedy_decode_match_the_jax_model(arch):
    # the dense families' cached path: granite's multi-query attention and
    # GELU MLP, phi3's MHA, internvl2's vision prefix, which the prefill
    # writes into the cache before the prompt
    cfg = configs.scaled_down(configs.resolve(arch))
    rcfg = _ref_cfg(cfg)
    r_rc, rc = _rc(cfg.name)
    r_params, params = _pair(cfg, 2)
    B, S, steps, max_seq = 2, 16, 4, 32
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab_size, (B, S))
    r_batch, batch = {"tokens": jnp.asarray(tokens)}, {"tokens": torch.from_numpy(tokens)}
    prefix = 0
    if cfg.frontend:
        prefix = cfg.frontend_len
        fe = rng.standard_normal((B, prefix, cfg.d_model), dtype=np.float32)
        r_batch["frontend"], batch["frontend"] = jnp.asarray(fe), torch.from_numpy(fe)
    r_logits, r_cache = r_model.prefill(r_params, rcfg, r_rc, r_batch,
                                        r_model.init_cache(rcfg, B, max_seq))
    logits, cache = M.prefill(params, cfg, rc, batch,
                              M.init_cache(cfg, B, max_seq, device="cpu"))
    np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits), atol=TOL, rtol=TOL)
    assert cache["len"] == int(r_cache["len"]) == prefix + S
    # the uncached forward's last position gives the same logits
    h, _, _ = M.forward(params, cfg, rc, batch)
    torch.testing.assert_close(T.logits_last(params, cfg, rc, h), logits,
                               atol=TOL, rtol=TOL)
    r_tok = jnp.argmax(r_logits[:, -1], -1)[:, None]
    tok = logits[:, -1].argmax(-1)[:, None]
    for _ in range(steps):
        assert np.array_equal(tok.numpy(), np.asarray(r_tok))
        r_logits, r_cache = r_model.decode(r_params, rcfg, r_rc, r_tok, r_cache)
        logits, cache = M.decode(params, cfg, rc, tok, cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits), atol=TOL, rtol=TOL)
        r_tok = jnp.argmax(r_logits[:, -1], -1)[:, None]
        tok = logits[:, -1].argmax(-1)[:, None]
    assert np.array_equal(tok.numpy(), np.asarray(r_tok))
    assert cache["len"] == int(r_cache["len"]) == prefix + S + steps


def test_full_width_one_layer_qwen3_matches_the_jax_model():
    # width, heads, head_dim 128 and d_ff at full size; one layer, a
    # 512-token vocabulary, float32.  Tolerance: TOL, as the reduced model
    # (the logits are O(1); float32 sums over d_model 1024 and d_ff 3072
    # differ from XLA's by ~1e-6).
    cfg = dataclasses.replace(configs.resolve("qwen3"), n_layers=1, vocab_size=512,
                              dtype="float32", max_seq_len=64)
    rcfg = _ref_cfg(cfg)
    r_rc, rc = _rc(cfg.name)
    r_params, params = _pair(cfg, 3)
    tokens = np.random.default_rng(3).integers(0, 512, (1, 32))
    r_logits, _ = r_model.prefill(r_params, rcfg, r_rc, {"tokens": jnp.asarray(tokens)},
                                  r_model.init_cache(rcfg, 1, 40))
    logits, _ = M.prefill(params, cfg, rc, {"tokens": torch.from_numpy(tokens)},
                          M.init_cache(cfg, 1, 40, device="cpu"))
    assert logits.shape == (1, 1, 512)
    np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits), atol=TOL, rtol=TOL)


def test_serve_runs_the_reduced_config_on_the_cpu(capsys):
    ids = serve.main(["--arch", "qwen3", "--requests", "2", "--prompt-len", "8",
                      "--gen", "4", "--device", "cpu"])
    assert ids.shape == (2, 4) and ids.dtype.kind == "i"
    assert (ids >= 0).all() and (ids < 256).all()
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 3 and out[0].startswith("[serve] qwen3-0.6b: 2 requests")
    again = serve.main(["--arch", "qwen3", "--requests", "2", "--prompt-len", "8",
                        "--gen", "4", "--device", "cpu"], kernels=ops.PLAIN)
    assert np.array_equal(ids, again)


@pytest.mark.parametrize("arch", NAMES)
def test_serve_runs_every_registry_arch_reduced_on_the_cpu(arch, capsys):
    # MoE sublayers, the encoder-decoder and the frontends included; the
    # wrappers on CPU tensors and the plain versions give the same ids
    argv = ["--arch", arch, "--requests", "2", "--prompt-len", "8", "--gen", "4",
            "--device", "cpu"]
    ids = serve.main(argv)
    cfg = configs.resolve(arch)
    assert ids.shape == (2, 4) and ((ids >= 0) & (ids < 256)).all()
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 3 and out[0].startswith(f"[serve] {cfg.name}: 2 requests")
    assert np.array_equal(serve.main(argv, kernels=ops.PLAIN), ids)


def test_unported_models_and_cases_raise():
    # What the card still refuses: K2 takes no logit softcap and numbers
    # queries from 0.  Meta tensors stand in for CUDA ones (the dispatch
    # looks at the device type and shapes only).
    cfg = dataclasses.replace(configs.scaled_down(configs.resolve("qwen3")),
                              logit_softcap=30.0)
    params = L.param_specs_of(lambda gen: L.init_attention(gen, cfg, torch.float32))
    x = torch.empty(1, 16, cfg.d_model, device="meta")
    with pytest.raises(NotImplementedError, match="softcap"):
        L.attention_block(params, x, cfg, mixer="attn", positions=range(16))
    cfg = dataclasses.replace(cfg, logit_softcap=0.0)
    kv = torch.empty(1, 32, cfg.n_kv_heads, cfg.resolved_head_dim, device="meta")
    with pytest.raises(NotImplementedError, match="position 0"):
        L.attention_block(params, x, cfg, mixer="attn", positions=range(4, 20),
                          cache={"k": kv, "v": kv.clone(), "len": 4})
    # an MoE sublayer's tokens must fill its groups (the reference asserts)
    moe_cfg = configs.scaled_down(configs.resolve("mixtral"))  # groups of 16
    moe_params = M.init_params(moe_cfg, device="cpu")
    with pytest.raises(ValueError, match="not divisible by group size"):
        M.forward(moe_params, moe_cfg, configs.RunConfig(),
                  {"tokens": torch.zeros(1, 17, dtype=torch.long)})


@pytest.mark.parametrize("case,kw", [
    ("softcap", dict(logit_cap=30.0)),
    ("position 0", dict(q_pos=range(4, 20))),
    ("ring cache", dict(kv_pos=torch.arange(16))),
    ("kv_len", dict(kv_len=8)),
])
def test_the_card_path_names_what_the_kernel_does_not_take(case, kw):
    # meta tensors stand in for CUDA ones: the dispatch looks at shapes only
    q = torch.empty(1, 16, 2, 32, device="meta")
    k = torch.empty(1, 16, 1, 32, device="meta")
    args = dict(q_pos=range(16), kv_pos=range(16))
    args.update(kw)
    with pytest.raises(NotImplementedError, match=case):
        L.attention_chunked(q, k, k, **args)


def test_cpu_attention_loop_matches_the_materialised_reference():
    # the plain loop computes the whole reference function: softcap,
    # kv_len and positions not starting at 0
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               for s in ((2, 8, 4, 16), (2, 24, 2, 16), (2, 24, 2, 16)))
    kw = dict(q_pos=torch.arange(12, 20), kv_pos=torch.arange(24), mixer="attn",
              kv_len=20, logit_cap=5.0)
    got = L.attention_chunked(q, k, v, kv_block=8, **kw)
    torch.testing.assert_close(got, L.attention_reference(q, k, v, **kw),
                               atol=1e-5, rtol=1e-5)
