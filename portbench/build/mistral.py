"""Mistral without a sliding window runs as a Llama-architecture block."""
from portbench.build.llama import *  # noqa: F401,F403
