"""Models whose fusion groups the evaluator prices."""
