"""Plain references, one module per kind of model, named by a
configuration's ``reference`` key: PyTorch operations in float32 with TF32
off, importing nothing of the port."""
