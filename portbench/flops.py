"""Model FLOPs from a configuration's shapes: the products (two FLOPs a
multiply-add) of a forward pass, as the program computes them: every
projection, the SSD's four products and the head over the padded
vocabulary. Element-wise work (convolution taps, norms, softmax, the
state recurrence across chunks) is not counted. A train step is three forward passes: the backward
computes two products for each one of the forward; recomputation is not
counted. ``m`` is a configuration file's ``model`` section.
"""

from __future__ import annotations

from typing import Dict


def mamba2_layer(m: Dict, b: int, s: int) -> int:
    D, N, hd = m["d_model"], m["ssm_state"], m["ssm_head_dim"]
    di = m["ssm_expand"] * D
    H = di // hd
    Q = min(m["ssm_chunk"], s)
    c = s // Q
    proj = 2 * b * s * D * (2 * di + 2 * N + H) + 2 * b * s * di * D
    ssd = (2 * b * c * Q * Q * N            # C . B inside each chunk
           + 2 * b * c * H * Q * Q * hd     # the masked product with x
           + 2 * b * c * Q * N * H * hd     # each chunk's state
           + 2 * b * c * Q * N * H * hd)    # the states into the outputs
    return proj + ssd


def forward(m: Dict, b: int, s: int) -> int:
    """FLOPs of one forward pass over a batch of ``b`` rows of ``s``
    tokens, logits at every position."""
    head = 2 * b * s * m["d_model"] * m["padded_vocab"]
    return m["n_layers"] * mamba2_layer(m, b, s) + head


def train_step(m: Dict, b: int, s: int) -> int:
    return 3 * forward(m, b, s)
