"""Models whose fusion groups the evaluator prices.

``vgg``, ``resnet`` and ``mobilenet`` double as evaluator workloads: the
tracing frontend (:mod:`repro_torch.core.frontend`) traces their
``forward(params, x)`` over ``param_specs()`` (meta tensors, nothing
materialised); ``transformer.block_forward``, ``ssm.mamba_block`` and
``moe.moe_block`` give the config zoo's blocks.
"""
