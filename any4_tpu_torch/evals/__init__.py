"""Evaluation (counterpart of ``any4_tpu/evals/``): perplexity, the LM
protocol of lm-evaluation-harness, BigCode-style code eval, weight and
quantization analysis, and the harness that logs results."""
