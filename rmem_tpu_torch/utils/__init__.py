from rmem_tpu_torch.utils.checkpoint import params_from_jax  # noqa: F401
