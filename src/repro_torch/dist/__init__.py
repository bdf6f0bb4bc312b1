"""``repro_torch.dist``: the distribution layer of the port, the
counterpart of ``repro.dist``.

* :mod:`repro_torch.dist.compat` — one spelling for the
  ``torch.distributed`` collectives that moved between releases, and
  :func:`~repro_torch.dist.compat.make_mesh`;
* :mod:`repro_torch.dist.sharding` — the spec engine (param, batch,
  optimizer-state, cache and boundary-save specs from tree paths), the
  :class:`~repro_torch.dist.sharding.Mesh`, placement of tensors on it
  (``place``/``gather``) and the gradient reduction over its batch axes;
* :mod:`repro_torch.dist.compression` — int8 cross-pod gradient
  reduction (``int8_psum``/``psum_tree``) and the ``wire_bytes`` model.
"""
from repro_torch.dist import compat, compression, sharding  # noqa: F401
