"""Llama-family forward, generation and checkpoints."""
