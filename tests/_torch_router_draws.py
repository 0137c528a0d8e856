"""The reference router's own draws, handed to the port's router (CPU
tests only: imports JAX).

``RecordingRouter`` is ``repro.sched.PodRouter`` recording the candidates
its ``_sample_candidates`` returns and the keys ``_next_key`` hands out;
``ReferenceDraws`` is the port's ``RouterDraws`` seam replaying them in
the same order (the full variant's tie permutation recomputed as
``jax.random.permutation(key, M)``).  Nothing in ``repro`` is edited.
"""
import jax
import numpy as np
import torch

import repro.sched as jsched


class RecordingRouter(jsched.PodRouter):
    """The reference's router, recording every random draw it makes."""

    def __init__(self, *a, **kw):
        self.keys, self.cands = [], []
        super().__init__(*a, **kw)

    def _next_key(self):
        sub = super()._next_key()
        self.keys.append(sub)
        return sub

    def _sample_candidates(self, cls, locals_):
        out = super()._sample_candidates(cls, locals_)
        self.cands.append(out)
        return out


class ReferenceDraws:
    """The port's draw seam fed from a ``RecordingRouter``'s records: the
    n-th call gets the reference's n-th draw (so the reference routes a
    batch before the port routes it)."""

    def __init__(self, ref: RecordingRouter):
        self.ref, self.n_cand, self.n_key = ref, 0, 0

    def candidates(self, cls, locals_):
        idx, ccls, valid = self.ref.cands[self.n_cand]
        self.n_cand += 1
        self.n_key += 1      # the pod variant draws one key a batch for these
        return (torch.from_numpy(idx), torch.from_numpy(ccls),
                torch.from_numpy(valid))

    def prio(self, M):
        key = self.ref.keys[self.n_key]
        self.n_key += 1
        return torch.from_numpy(
            np.asarray(jax.random.permutation(key, M)).astype(np.int32))
