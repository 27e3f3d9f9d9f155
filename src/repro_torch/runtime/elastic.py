"""Elastic re-scaling: resume on a different mesh, degrade a sick one.

When the mesh changes (2 pods -> 1 after a pod loss, or 1 -> 2 on
scale-up), the parameters and optimizer state are re-placed from the host
checkpoint onto the new mesh's sharding rules (:func:`resume_on_mesh`).
Nothing about the checkpoint format is mesh-specific (host numpy and
key paths), so this is pure re-placement.  A checkpoint written by this
package (one entry per layer) or by the JAX reference (each segment's
layers stacked) restores alike.

:func:`sweep_degradation_ladder` is the layout fallback the fleet sweep
walks when its device layout keeps failing: the split sweep and the
single-device sweep are bit-identical by construction (every raw row is
computed independently of the others), so degrading mid-sweep changes
wall-clock, never answers.

The model-stack imports are function-local so the evaluator core can use
the ladder without the training stack.
"""
from __future__ import annotations


def sweep_degradation_ladder(devices) -> tuple:
    """Device layouts a sick sweep falls back through, best first.

    ``devices`` is :func:`repro_torch.core.flow.run_fleet`'s layout spec
    (None = single device; an int or device sequence = a split of the
    hardware axis).  The ladder is the requested layout followed by the
    single-device sweep.  Results are bit-identical at every rung, so
    walking down the ladder trades only throughput, never correctness.
    """
    if devices is None:
        return (None,)
    return (devices, None)


def shardings_for(cfg, mesh, opt_cfg):
    """(param, opt-state) shardings of config ``cfg`` on ``mesh``."""
    from ..models import model as M
    from ..optim import init_opt_state
    from ..parallel import sharding as SH

    aparams = M.abstract_params(cfg)
    pshard = SH.param_shardings(mesh, aparams)
    aopt = init_opt_state(aparams, opt_cfg)
    return pshard, SH.opt_state_shardings(mesh, aopt, pshard)


def _tree_from_flat(flat: dict, like, prefix: str):
    """The tree shaped like ``like`` (this package's layout) whose leaves
    are the entries of a checkpoint's flat dict under ``prefix``: a leaf's
    own key, or else its layer of the reference's stacked entry.  A
    missing entry or a shape other than ``like``'s raises."""
    from ..checkpoint.checkpoint import SEP
    from ..parallel import sharding as SH

    def one(path, ref, layer, leaf):
        key = SEP.join([prefix] + path)
        if key in flat:
            a = flat[key]
        else:
            rkey = SEP.join([prefix] + ref)
            if layer is None or rkey not in flat:
                raise KeyError(f"checkpoint has neither {key} nor {rkey}")
            a = flat[rkey][layer[0]]
        if tuple(a.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(a.shape)}, model "
                             f"shape {tuple(leaf.shape)}")
        return a

    return SH.map_layers(one, like)


def resume_on_mesh(ckpt_dir, step: int, cfg, new_mesh, *, opt_cfg=None):
    """Restore step ``step`` re-sharded onto ``new_mesh``.

    Returns (params, opt_state): this rank's pieces under
    :func:`shardings_for`, on the mesh's device."""
    from .. import checkpoint as CKPT
    from ..models import model as M
    from ..optim import AdamWConfig, init_opt_state

    opt_cfg = opt_cfg or AdamWConfig()
    aparams = M.abstract_params(cfg)
    aopt = init_opt_state(aparams, opt_cfg)
    flat, _ = CKPT.restore(ckpt_dir, step)
    pshard, oshard = shardings_for(cfg, new_mesh, opt_cfg)
    params = CKPT.device_put_like(_tree_from_flat(flat, aparams, "params"), pshard)
    opt = CKPT.device_put_like(_tree_from_flat(flat, aopt, "opt"), oshard)
    return params, opt
