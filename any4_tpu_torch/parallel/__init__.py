"""Tensor/data parallelism (:mod:`.tp`) and multi-host set-up
(:mod:`.distributed`) on ``torch.distributed``."""
