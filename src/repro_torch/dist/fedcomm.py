"""The federated upload through the wire (host-loop path of
``train/fed_trainer``).

Each client's uploaded delta passes through ``quantize_update``: the
int8/bf16 encode with an error-feedback residual carried per client between
rounds, so Algorithm 1 aggregates exactly what the wire delivers.  The
encode is the fused hop kernel (``repro_torch.kernels.wire_hop``) in its
quantize-only form; the reference's mesh path (the ring all-reduce) is not
ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import tree as tree_util
from repro_torch.core.comm import wire_format, wire_qblock
from repro_torch.kernels.wire_hop import dequant_chunk, fused_hop


@torch.no_grad()
def quantize_update(tree, residual=None, *, wire: str = None,
                    qblock: int = None):
    """One client upload through the wire: quantize the delta tree (EF
    residual added in), return what the server dequantizes plus the new
    residual (flat f32, padded to whole ``qblock`` rows, carried to this
    client's next round).  The f32 wire is the identity.  Leaves are laid
    end to end in the reference's order (sorted keys), so the residual and
    the blocks line up with the reference's."""
    wire = wire or wire_format()
    qblock = qblock or wire_qblock()
    if wire == "f32":
        return tree, residual
    flat = tree_util.ravel(tree)
    padded = F.pad(flat, (0, -flat.numel() % qblock))
    res = (torch.zeros_like(padded) if residual is None
           else residual.float())
    # encode t = value + residual, keep the wire's loss as the new residual
    t = padded + res
    _, codes, scales, new_res = fused_hop(t, None, None, torch.zeros_like(t),
                                          wire=wire, qblock=qblock)
    deq = dequant_chunk(codes, scales, wire=wire, qblock=qblock)
    return tree_util.unravel(tree, deq), new_res
