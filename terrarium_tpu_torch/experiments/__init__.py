"""Hopper counterparts of the repository's probe experiments, each a
hand-written CUDA kernel (``csrc/probes.cu``) beside its plain PyTorch
version, in modules named after the files they port:
``roofline_census`` (``run_micro``), ``mosaic_bisect`` (``run_case``) and
``mosaic_min_repro`` (``run_variant``). Run on the card as
``python -m terrarium_tpu_torch.experiments.<module>``."""
