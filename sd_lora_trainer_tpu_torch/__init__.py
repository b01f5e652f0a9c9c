"""PyTorch/CUDA port of the SD LoRA trainer for one NVIDIA H100.

The JAX package sd_lora_trainer_tpu is the reference; this package never
imports it or jax.
"""
