"""Card microbenchmarks of the port: counterparts of the repository's
``benchmark/`` scripts that time one kernel alone.  They import nothing of
that folder, of ``lara_tpu`` or of JAX."""
