"""Models of the port and their weight loaders."""
from .gpt import GPTConfig, GPTForCausalLM
from .weights import gpt_state_from_jax, gpt_state_to_jax, load_gpt_from_jax

__all__ = ["GPTConfig", "GPTForCausalLM", "gpt_state_from_jax",
           "gpt_state_to_jax", "load_gpt_from_jax"]
