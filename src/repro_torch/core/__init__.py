"""Evaluator core: IR, the tracing frontend (``frontend``: PyTorch models
to ``GraphIR`` over meta tensors), Eq. (1)-(4) metrics, fusion search and
the flow."""
