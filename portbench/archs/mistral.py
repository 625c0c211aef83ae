"""Mistral without a sliding window is a Llama-architecture block."""
from portbench.archs.llama import *  # noqa: F401,F403
