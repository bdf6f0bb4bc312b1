"""repro_torch.quant — post-training int8 quantization of SLTrain weights
for serving, the port of ``repro.quant``.

* :mod:`repro_torch.quant.layout` — the quantized tile-CSR layout: int8
  codes and int16 tile-local indices at the deterministic
  ``support.tile_cap`` geometry, per-output-channel f32 scales blocked by
  column tile, and the modeled decode-bytes accounting.
* :mod:`repro_torch.quant.calibrate` — the one-shot activation-free
  quantizer (per-channel symmetric int8 scales on W = scale·B·A ⊕ V, the
  sparse values quantized against them, the residual error SVD-folded
  into the low-rank factors) and its CLI
  (``python -m repro_torch.quant.calibrate``), which turns a training
  checkpoint into a versioned quant artifact (ckpt/checkpoint.py).

Submodules import lazily (``from repro_torch.quant import calibrate``):
an eager import here would trip runpy's double-import warning under
``python -m repro_torch.quant.calibrate``.
"""
