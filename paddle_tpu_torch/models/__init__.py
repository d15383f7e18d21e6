"""Models of the port and their weight loaders."""
from .gpt import GPTConfig, GPTForCausalLM
from .llama import LlamaConfig, LlamaForCausalLM, rope_angles
from .weights import (gpt_state_from_jax, gpt_state_to_jax,
                      llama_state_from_jax, llama_state_to_jax,
                      load_gpt_from_jax, load_llama_from_jax)

__all__ = ["GPTConfig", "GPTForCausalLM", "LlamaConfig", "LlamaForCausalLM",
           "rope_angles", "gpt_state_from_jax", "gpt_state_to_jax",
           "llama_state_from_jax", "llama_state_to_jax", "load_gpt_from_jax",
           "load_llama_from_jax"]
