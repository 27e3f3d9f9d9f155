"""Hypothesis property: the port's tracing frontend never leaks raw
exceptions — the counterpart of tests/test_faults_property.py.

Random degenerate PyTorch functions (hostile shapes, ops no layer maps to,
batch sizes != 1, rank mismatches) make ``frontend.trace`` either return a
valid graph or raise ``UnsupportedOpError`` / ``GraphValidationError``,
never a raw ``KeyError`` / ``IndexError`` / ``AttributeError`` from inside
the tracer.  Skipped when hypothesis is absent, per suite convention.
"""
import pytest
import torch
import torch.nn.functional as Fn

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.core import frontend as F  # noqa: E402
from repro_torch.core.errors import GraphValidationError, UnsupportedOpError  # noqa: E402


def _meta(*shape):
    return torch.empty(shape, device="meta")


_OPS = {  # tests/test_faults_property.py, in PyTorch
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sum": torch.sum,
    "transpose": lambda x: x.T if x.dim() == 2 else x,
    "sort": lambda x: torch.sort(x)[0],
    "square": lambda x: x * x,
    "add_self": lambda x: x + x,
    "reshape": lambda x: x.reshape(-1),
    "slice": lambda x: x[..., :1],
    "cumsum": lambda x: torch.cumsum(x.reshape(-1), 0),
}


@given(op_names=st.lists(st.sampled_from(sorted(_OPS)), min_size=1, max_size=3),
       shape=st.lists(st.integers(1, 8), min_size=1, max_size=4))
@settings(max_examples=60, deadline=None)
def test_trace_failures_are_typed(op_names, shape):
    def fn(x):
        for name in op_names:
            x = _OPS[name](x)
        return x

    try:
        g = F.trace(fn, _meta(*shape), name="fuzz")
    except (UnsupportedOpError, GraphValidationError):
        return
    except (KeyError, IndexError, AttributeError, TypeError,
            AssertionError) as e:  # pragma: no cover - the bug we hunt
        pytest.fail(f"trace leaked raw {type(e).__name__} for {op_names} @ {shape}: {e}")
    g.validate()


@given(matmul_k=st.integers(1, 16), batch=st.integers(1, 4),
       features=st.integers(1, 16), rank=st.integers(1, 4))
@settings(max_examples=40, deadline=None)
def test_trace_products_and_pools_of_odd_shapes_are_typed(matmul_k, batch, features, rank):
    """Weight/activation shape mismatches, batch > 1 and odd ranks come
    back as typed errors (or trace fine), never raw tracer internals."""
    x = _meta(*([batch] * (rank - 1) + [matmul_k]))
    fns = [
        (lambda w, x: x @ w, _meta(matmul_k, features)),
        (lambda w, x: x @ w, _meta(features, matmul_k)),
        (lambda w, x: Fn.max_pool2d(x, 2) + w, _meta(1)),
        (lambda w, x: x.mean(dim=(1, 2)) @ w, _meta(matmul_k, features)),
    ]
    for fn, w in fns:
        try:
            g = F.trace(fn, w, x, name="fuzz-ops")
        except (UnsupportedOpError, GraphValidationError):
            continue
        g.validate()
