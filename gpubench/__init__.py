"""The benchmark of ``lara_tpu_torch``, the PyTorch and CUDA port, on
NVIDIA H100 cards: all-pairs family jobs through ``lara_tpu_torch.app.run``
(see ``gpubench/README.md``).  Nothing here imports JAX or the JAX
package."""
