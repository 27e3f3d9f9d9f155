"""Evaluator core: IR, Eq. (1)-(4) metrics, fusion search and the flow."""
