"""The masked LSTMs of the Motifs context
(``veto_tpu/models/relation/legacy/lstm.py``).

The reference runs torch LSTMs over PackedSequences of proposals sorted by
centre x; the JAX package, and this port, keep the sequences on the padded
(B, N) axis with a mask, the sort an explicit permutation per image
(:func:`centerx_perm`, padding last).  A padded step leaves the state as it
was and outputs 0, so the reverse direction starts at each image's last
valid proposal, as a packed sequence would.

:class:`MaskedBiLSTM` is flax's ``OptimizedLSTMCell`` stepped both ways:
``i, f, g, o`` gates from ``h @ W_hh + b`` (one bias a gate, on the
recurrent side) plus ``x @ W_ih``, the carry zero-initialised in f32 and
the gates computed in the model's dtype.  Each direction holds its gates'
matrices stacked in torch's (i, f, g, o) row order (``weight_ih`` (4H, D),
``weight_hh`` (4H, H), ``bias`` (4H)); the weight bridge stacks flax's
per-gate ``ii``..``io`` / ``hi``..``ho`` tensors so.  ``torch.nn.LSTM``
would carry two biases a gate, and the optimizer groups a tensor by its
leaf named ``bias``.  The input products of every step are one GEMM before
the loop; each step of the loop runs both directions at once (one batched
product for the two recurrent matrices).  The JAX package computes the
LSTMs with XLA, outside any Pallas kernel, and so does the port.

:class:`HighwayDecoderLSTM` is the Motifs ``DecoderRNN`` (a highway LSTM
cell) stepped over the sorted proposals, feeding back the label embedding
(table with a 'start' row 0, labels shifted by +1): the GT label at train
(background replaced by the argmax foreground), the argmax foreground at
eval.  Its parameters keep the JAX module's explicit names and (in, out)
layout.  With ``num_att_classes`` > 0 it is the attribute variant: every
timestep input also carries the attribute table's 'start' row 0, which
stays constant (the reference assigns the previous attribute embedding
only after its loop), and a second head ``att_out_w`` / ``att_out_b``
gives each step's f32 attribute logits.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ....ops.nms import first_argmax


def centerx_perm(boxes: torch.Tensor, mask: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N, 4), (B, N) → (perm, inv) (B, N) int64: ``x[perm]`` orders each
    image's valid proposals by centre x, descending (right to left, the
    reference's ``sort_rois``), padding last, ties in index order (a stable
    sort, as ``jnp.argsort``); ``y[inv]`` undoes it."""
    cx = 0.5 * (boxes[..., 0] + boxes[..., 2])
    key = torch.where(mask, -cx, float("inf"))
    perm = torch.argsort(key, dim=-1, stable=True)
    return perm, torch.argsort(perm, dim=-1, stable=True)


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x`` (B, N, ...) at ``idx`` (B, P) along axis 1 (the JAX module's
    ``_gather``)."""
    idx = idx.long().reshape(idx.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(idx.shape[:2] + x.shape[2:]))


class LSTMDirection(nn.Module):
    """One direction's stacked (i, f, g, o) LSTM parameters."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden, in_features))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden, hidden))
        self.bias = nn.Parameter(torch.zeros(4 * hidden))


class MaskedBiLSTM(nn.Module):
    """Bidirectional masked LSTM: (B, N, D), (B, N) → (B, N, 2 hidden), f32
    whatever the compute dtype (the carry's)."""

    def __init__(self, in_features: int, hidden: int, num_layers: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden, self.num_layers, self.dtype = hidden, num_layers, dtype
        for layer in range(num_layers):
            d = in_features if layer == 0 else 2 * hidden
            self.add_module(f"fwd{layer}", LSTMDirection(d, hidden))
            self.add_module(f"bwd{layer}", LSTMDirection(d, hidden))

    def _layer(self, x: torch.Tensor, mask: torch.Tensor, layer: int) -> torch.Tensor:
        cdt, h = self.dtype, self.hidden
        b, n, _ = x.shape
        dirs = (getattr(self, f"fwd{layer}"), getattr(self, f"bwd{layer}"))
        x = x.to(cdt)
        xp = [torch.matmul(x, d.weight_ih.to(cdt).t()) for d in dirs]  # (B, N, 4H)
        w_hh = torch.stack([d.weight_hh.to(cdt).t() for d in dirs])    # (2, H, 4H)
        bias = torch.stack([d.bias.to(cdt) for d in dirs])[:, None]     # (2, 1, 4H)
        hs = torch.zeros((2, b, h), dtype=torch.float32, device=x.device)
        cs = torch.zeros_like(hs)
        outs = [[None] * n, [None] * n]
        for step in range(n):
            ts = (step, n - 1 - step)
            g = torch.baddbmm(bias, hs.to(cdt), w_hh)
            g = g + torch.stack([xp[0][:, ts[0]], xp[1][:, ts[1]]])
            i, f, gg, o = g.chunk(4, dim=-1)
            new_c = torch.sigmoid(f) * cs + torch.sigmoid(i) * torch.tanh(gg)
            new_h = torch.sigmoid(o) * torch.tanh(new_c)
            keep = torch.stack([mask[:, ts[0]], mask[:, ts[1]]])[..., None]
            cs = torch.where(keep, new_c, cs)
            hs = torch.where(keep, new_h, hs)
            out = torch.where(keep, new_h, 0.0)
            outs[0][ts[0]], outs[1][ts[1]] = out[0], out[1]
        return torch.cat([torch.stack(outs[0], 1), torch.stack(outs[1], 1)], -1)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        for layer in range(self.num_layers):
            x = self._layer(x, mask, layer)
        return x


class HighwayDecoderLSTM(nn.Module):
    """The Motifs decoder: (B, N, D) sorted inputs, (B, N) mask, sorted GT
    labels (train) → logits (B, N, C) f32 and refined labels (B, N) int32
    (0 on padding); with ``num_att_classes`` > 0 also the attribute logits
    (B, N, A) f32."""

    def __init__(self, num_obj_classes: int, in_features: int,
                 embed_dim: int = 200, hidden: int = 512, num_att_classes: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c, e, h = num_obj_classes, embed_dim, hidden
        self.hidden, self.dtype = h, dtype
        self.att_on = num_att_classes > 0
        self.obj_embed = nn.Parameter(torch.empty(c + 1, e))
        if self.att_on:
            self.att_embed = nn.Parameter(torch.empty(num_att_classes, e))
            self.att_out_w = nn.Parameter(torch.empty(h, num_att_classes))
            self.att_out_b = nn.Parameter(torch.zeros(num_att_classes))
        extra = 2 * e if self.att_on else e
        self.input_w = nn.Parameter(torch.empty(in_features + extra, 6 * h))
        self.input_b = nn.Parameter(torch.zeros(6 * h))
        self.state_w = nn.Parameter(torch.empty(h, 5 * h))
        self.state_b = nn.Parameter(torch.zeros(5 * h))
        self.out_w = nn.Parameter(torch.empty(h, c))
        self.out_b = nn.Parameter(torch.zeros(c))

    def forward(self, feats: torch.Tensor, mask: torch.Tensor,
                gt_labels: Optional[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        cdt, h = self.dtype, self.hidden
        b, n, d = feats.shape
        table = self.obj_embed.to(cdt)
        w_in = self.input_w.to(cdt)
        b_in, w_st, b_st = (self.input_b.to(cdt), self.state_w.to(cdt),
                            self.state_b.to(cdt))
        # the timestep input is [x_t, previous embedding]: x_t's product for
        # every step at once, the embedding's a step at a time
        xp = torch.matmul(feats.to(cdt), w_in[:d]) + b_in
        if self.att_on:  # the constant attribute 'start' row
            e = table.shape[1]
            xp = xp + torch.matmul(self.att_embed[0].to(cdt), w_in[d + e:])
            w_prev = w_in[d:d + e]
        else:
            w_prev = w_in[d:]
        teacher = self.training and gt_labels is not None
        state = torch.zeros((b, h), dtype=cdt, device=feats.device)
        memory = torch.zeros_like(state)
        prev = table[0].expand(b, -1)
        cls_idx = torch.arange(self.out_b.shape[0] - 1, device=feats.device).expand(b, -1)
        logits, labels, atts = [], [], []
        for t in range(n):
            pi = xp[:, t] + torch.matmul(prev, w_prev)
            ps = torch.addmm(b_st, state, w_st)

            def gate(k):
                return pi[:, k * h:(k + 1) * h] + ps[:, k * h:(k + 1) * h]

            new_memory = (torch.sigmoid(gate(0)) * torch.tanh(gate(2))
                          + torch.sigmoid(gate(1)) * memory)
            out = torch.sigmoid(gate(3)) * torch.tanh(new_memory)
            hw = torch.sigmoid(gate(4))
            new_state = hw * out + (1.0 - hw) * pi[:, 5 * h:]
            logit = torch.addmm(self.out_b, new_state.float(), self.out_w)
            if self.att_on:
                atts.append(torch.addmm(self.att_out_b, new_state.float(),
                                        self.att_out_w))
            fg = first_argmax(logit[:, 1:], cls_idx) + 1
            refined = torch.where(gt_labels[:, t] > 0, gt_labels[:, t].long(), fg) \
                if teacher else fg
            m = mask[:, t, None]
            state = torch.where(m, new_state, state)
            memory = torch.where(m, new_memory, memory)
            prev = torch.where(m, table[refined + 1], prev)
            logits.append(logit)
            labels.append(torch.where(mask[:, t], refined, 0))
        out = (torch.stack(logits, 1), torch.stack(labels, 1).to(torch.int32))
        return out + (torch.stack(atts, 1),) if self.att_on else out
