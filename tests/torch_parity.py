"""Shared comparisons of the port's parity tests (imported by the
``test_torch_*`` files; pytest collects nothing here).

:func:`assert_step_checksums` holds one train step's ADCC checksums, as
the port's ``build_train_step`` returns them, against the reference's.

Parameters and optimizer state are sums of large, smooth values: they
agree to ``rtol 1e-5, atol 1e-3``. The applied updates are held to the
rounding of their own scale, ``1e-4 * max|want|``, plus what AdamW's
arithmetic lets one rounding-sized gradient do. AdamW moves an element
by ``lr_t * m_hat / (sqrt(v_hat) + eps)``; in the first steps
``m_hat / sqrt(v_hat)`` is ``g / |g|`` for any gradient well above
``eps`` (1e-8), so the update of an element whose gradient is the size
of float32 rounding (1e-9 to 3e-8 apart between the packages) is
anywhere in ``(-lr_t, lr_t)``, and the two packages' updates of it
differ by up to ``2 * lr_t``. The per-element comparison of the
parameters after the steps allows exactly that (``2 * lr + 1e-6``); a
leaf's update checksum gets it once, for one such element.
"""

from __future__ import annotations

import numpy as np
import torch

from repro.core import acc_state as ref_acc
from repro_torch.core.acc_state import flatten_checksums
from repro_torch.optim import lr_schedule

__all__ = ["update_checksum_atol", "assert_step_checksums",
           "assert_flat_checksums"]


def update_checksum_atol(want: np.ndarray, tcfg, step: int) -> float:
    """The bound on a leaf's update-checksum difference at ``step``
    (1-based, the optimizer's count after the update): the rounding of
    the checksums' scale plus ``2 * lr_t`` (see the module's note)."""
    lr_t = float(lr_schedule(tcfg, torch.tensor(step, dtype=torch.int32)))
    return 1e-4 * float(np.abs(want).max()) + 2 * lr_t


def assert_step_checksums(got_c, want_c, tcfg, step: int) -> None:
    """The port's ``checksums`` of a train step against the reference's:
    the same leaves, parameters and optimizer state at ``rtol 1e-5,
    atol 1e-3``, updates at :func:`update_checksum_atol`."""
    assert_flat_checksums(
        {k: flatten_checksums(got_c[k]) for k in ("params", "opt", "updates")},
        {k: ref_acc.flatten_checksums(want_c[k])
         for k in ("params", "opt", "updates")}, tcfg, step)


def assert_flat_checksums(got_c, want_c, tcfg, step: int) -> None:
    """:func:`assert_step_checksums` of checksums already flattened: a
    list per tree ("params", "opt", "updates") in the order of
    ``jax.tree.leaves``."""
    for k in ("params", "opt", "updates"):
        got, want = np.array(got_c[k]), np.array(want_c[k])
        assert got.shape == want.shape, k
        if k == "updates":
            np.testing.assert_allclose(
                got, want, rtol=0, atol=update_checksum_atol(want, tcfg, step))
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
