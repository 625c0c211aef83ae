"""The any4 learner (k-means over rows) and model quantization."""
