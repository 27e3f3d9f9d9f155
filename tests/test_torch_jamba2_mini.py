"""AI21-Jamba2-Mini (the Jamba 1.5 Mini architecture) on the port's prefill
path, on the CPU in float32 at a tiny size: one period of 8 layers
(attention at index 4 with no RoPE, seven Mamba-1 mixers with the dt/B/C
norms, the MoE on the odd layers with its top-2 gates not renormalised).

* The benchmark's plain reference (``portbench/reference/jamba.py``)
  against transformers' own ``JambaForCausalLM`` (its slow path, no Mamba
  kernels) on the same weights, at a capacity at which no claim drops:
  last-position logits, the attention layer's K and V, every Mamba
  layer's convolution inputs and final state, within 1e-5 relative.
* The port's ``make_prefill_step`` against that reference: logits, K and
  V, the Mamba states.
* The time-chunked Mamba prefill (at chunks that do not divide the prompt)
  against the one-call prefill: the same bits.
* ``moe.route_topk`` with and without renormalising the gates.
* Every registry config's parameter tree is unchanged by the Jamba
  switches' class-level defaults, and ``JambaConfig`` adds exactly the
  three inner norms to each Mamba mixer.
"""
import dataclasses
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the benchmark's reference

from portbench import program_hybrid as PH, weights_hybrid as WH  # noqa: E402
from portbench.reference import jamba as R  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import model as M, moe, ssm  # noqa: E402
from repro_torch.runtime.steps import make_prefill_step  # noqa: E402

TINY = {"name": "tiny-jamba", "reference": "jamba", "family": "hybrid", "n_layers": 8,
        "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16, "d_ff": 96,
        "vocab_size": 256,
        "layer_pattern": ["mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba"],
        "rope": False, "n_experts": 4, "top_k": 2, "moe_every": 2, "moe_offset": 1,
        "moe_renormalize": False, "capacity_factor": 2.0, "moe_group_size": 16,
        "ffn_act": "swiglu", "ssm_state": 8, "ssm_conv": 4, "ssm_expand": 2, "ssm_dt_rank": 8,
        "ssm_inner_norms": True, "rmsnorm_eps": 1e-6, "tie_embeddings": False,
        "dtype": "float32", "max_seq_len": 64, "embed_scale": 1.0}
ATTN = 4  # the attention layer's index
TOL = 1e-5


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm())


def _prompts(seed: int, B: int, S: int) -> torch.Tensor:
    return torch.randint(0, TINY["vocab_size"], (B, S),
                         generator=torch.Generator().manual_seed(seed))


def _reference(weights, tokens):
    """(last-position logits, [cache of each layer]) of the plain reference."""
    states = [None] * TINY["n_layers"]

    def keep(i, refs):
        states[i] = refs[0]

    drops = []
    logits = R.prefill(TINY, weights, [tokens], R.Arith("fp32"), keep, drops)[0]
    assert sum(d for d, _ in drops) == 0
    return logits, states


# ---------------------------------------------------------------------------
# the reference against transformers' JambaForCausalLM
# ---------------------------------------------------------------------------


def _hf_model(weights):
    from transformers import JambaConfig as HFConfig, JambaForCausalLM

    c = TINY
    hf = HFConfig(vocab_size=c["vocab_size"], hidden_size=c["d_model"],
                  intermediate_size=c["d_ff"], num_hidden_layers=c["n_layers"],
                  num_attention_heads=c["n_heads"], num_key_value_heads=c["n_kv_heads"],
                  num_experts=c["n_experts"], num_experts_per_tok=c["top_k"],
                  expert_layer_period=2, expert_layer_offset=1, attn_layer_period=8,
                  attn_layer_offset=ATTN, mamba_d_state=c["ssm_state"],
                  mamba_d_conv=c["ssm_conv"], mamba_expand=c["ssm_expand"],
                  mamba_dt_rank=c["ssm_dt_rank"], mamba_conv_bias=True, mamba_proj_bias=False,
                  use_mamba_kernels=False, rms_norm_eps=c["rmsnorm_eps"],
                  tie_word_embeddings=False, attn_implementation="eager")
    w = weights.all()
    sd = {"model.embed_tokens.weight": w["embed"], "lm_head.weight": w["lm_head"].T,
          "model.final_layernorm.weight": w["final_norm"]}
    for i in range(c["n_layers"]):
        p, g = f"model.layers.{i}.", lambda k: w[f"layers.{i}.{k}"]
        sd[p + "input_layernorm.weight"] = g("norm1")
        sd[p + "pre_ff_layernorm.weight"] = g("norm2")
        if WH.is_mamba(c, i):
            m = p + "mamba."
            sd.update({m + "in_proj.weight": g("in_proj").T,
                       m + "conv1d.weight": g("conv_w").T[:, None, :],
                       m + "conv1d.bias": g("conv_b"), m + "x_proj.weight": g("x_proj").T,
                       m + "dt_proj.weight": g("dt_proj").T, m + "dt_proj.bias": g("dt_bias"),
                       m + "A_log": g("A_log"), m + "D": g("D"),
                       m + "out_proj.weight": g("out_proj").T,
                       m + "dt_layernorm.weight": g("dt_norm"),
                       m + "b_layernorm.weight": g("b_norm"),
                       m + "c_layernorm.weight": g("c_norm")})
        else:
            for ours, theirs in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj"),
                                 ("wo", "o_proj")):
                sd[p + f"self_attn.{theirs}.weight"] = g(ours).T
        f = p + "feed_forward."
        names = (("w1", "gate_proj"), ("w3", "up_proj"), ("w2", "down_proj"))
        if f"layers.{i}.router" in w:
            sd[f + "router.weight"] = g("router").T
            for e in range(c["n_experts"]):
                for ours, theirs in names:
                    sd[f + f"experts.{e}.{theirs}.weight"] = g(ours)[e].T
        else:
            for ours, theirs in names:
                sd[f + f"{theirs}.weight"] = g(ours).T
    model = JambaForCausalLM(hf).eval()
    model.load_state_dict({k: v.contiguous() for k, v in sd.items()}, strict=True)
    return hf, model


@pytest.mark.parametrize("seed, B, S", [(0, 2, 32), (1, 1, 48), (2**31 + 5, 2, 16)])
def test_the_reference_matches_transformers_jamba(seed, B, S):
    from transformers.models.jamba.modeling_jamba import HybridMambaAttentionDynamicCache

    weights = WH.Weights(TINY, seed, "cpu")
    hf, model = _hf_model(weights)
    tokens = _prompts(seed, B, S)
    cache = HybridMambaAttentionDynamicCache(hf, B, dtype=torch.float32)
    with torch.no_grad():
        out = model(tokens, past_key_values=cache, use_cache=True)
    logits, states = _reference(weights, tokens)
    assert _rel(logits, out.logits[:, -1]) < TOL
    for i, state in enumerate(states):
        if WH.is_mamba(TINY, i):
            conv, h = state
            want_conv = cache.conv_states[i][..., 1:].transpose(1, 2)  # the last 3 inputs
            assert _rel(conv, want_conv) < TOL and _rel(h, cache.ssm_states[i]) < TOL
        else:
            k, v = state
            assert _rel(k, cache.key_cache[i].transpose(1, 2)) < TOL
            assert _rel(v, cache.value_cache[i].transpose(1, 2)) < TOL


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------


def _port_prefill(weights, tokens):
    """(last-position logits, [cache of each layer]) of the port's prefill
    step (the kernels' wrappers: their plain versions on the CPU)."""
    mcfg = PH.model_config(TINY)
    params, _ = PH.param_tree(mcfg, weights.all())
    step = make_prefill_step(mcfg, configs.RunConfig(remat="none"))
    cache = M.init_cache(mcfg, tokens.shape[0], tokens.shape[1], device="cpu")
    with torch.inference_mode():
        logits, cache = step(params, cache, {"tokens": tokens})
    return logits[:, -1], PH.states_by_layer(mcfg, cache)


@pytest.mark.parametrize("seed, B, S", [(3, 2, 32), (4, 1, 48), (2**33 + 1, 2, 40)])
def test_the_port_prefill_matches_the_reference(seed, B, S):
    weights = WH.Weights(TINY, seed, "cpu")
    tokens = _prompts(seed, B, S)
    got, got_states = _port_prefill(weights, tokens)
    want, want_states = _reference(weights, tokens)
    assert _rel(got, want) < 1e-4
    for g, w in zip(got_states, want_states):
        for a, b in zip(g, w):
            assert a.shape == b.shape and _rel(a, b) < 1e-4


@pytest.mark.parametrize("chunk", [1, 7, 13])
def test_the_time_chunked_prefill_is_the_one_call_prefill(chunk, monkeypatch):
    weights = WH.Weights(TINY, 5, "cpu")
    tokens = _prompts(5, 2, 40)
    whole = _port_prefill(weights, tokens)
    di, ds = TINY["ssm_expand"] * TINY["d_model"], TINY["ssm_state"]
    monkeypatch.setattr(ssm, "SCAN_BUDGET_BYTES", chunk * 2 * 4 * 2 * di * ds)
    assert ssm.time_chunk(2, di, ds) == chunk
    parts = _port_prefill(weights, tokens)
    assert torch.equal(parts[0], whole[0])
    for g, w in zip(parts[1], whole[1]):
        assert all(torch.equal(a, b) for a, b in zip(g, w))


# ---------------------------------------------------------------------------
# routing, and the registry's trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("renormalize", [True, False])
def test_route_topk_renormalizes_only_where_asked(renormalize):
    logits = torch.randn(3, 5, 16, generator=torch.Generator().manual_seed(0))
    gates, idx, probs = moe.route_topk(logits, 2, renormalize=renormalize)
    drawn = probs.gather(-1, idx)
    want = drawn / drawn.sum(-1, keepdim=True) if renormalize else drawn
    assert torch.equal(idx, torch.topk(torch.softmax(logits, -1), 2, dim=-1).indices)
    torch.testing.assert_close(gates, want, rtol=0, atol=1e-7)
    if renormalize:
        torch.testing.assert_close(gates.sum(-1), torch.ones(3, 5))
    else:
        assert bool((gates.sum(-1) < 1).all())


def _leaves(cfg) -> list:
    flat, _ = torch.utils._pytree.tree_flatten_with_path(M.abstract_params(cfg))
    return [(torch.utils._pytree.keystr(p), tuple(t.shape), t.dtype) for p, t in flat]


@pytest.mark.parametrize("arch", sorted(configs.REGISTRY))
def test_registry_parameter_trees_are_unchanged_by_the_jamba_switches(arch):
    cfg = configs.REGISTRY[arch]
    assert not {"rope", "moe_renormalize", "ssm_inner_norms"} & set(dataclasses.asdict(cfg))
    assert (cfg.rope, cfg.moe_renormalize, cfg.ssm_inner_norms) == (True, True, False)
    if cfg.is_encoder_decoder:
        return
    small = configs.scaled_down(cfg)
    plain = _leaves(small)
    assert not any(p.endswith(("['dt_norm']", "['b_norm']", "['c_norm']")) for p, *_ in plain)
    jamba = configs.JambaConfig(**dataclasses.asdict(small))
    added = sorted(set(_leaves(jamba)) - set(plain))
    n_mamba = sum(small.mixer_of(i) == "mamba" for i in range(small.n_layers))
    assert len(added) == 3 * n_mamba and set(plain) <= set(_leaves(jamba))
    counts = jamba.param_counts()["total"] - small.param_counts()["total"]
    assert counts == n_mamba * (small.dt_rank + 2 * small.ssm_state)
