"""Model substrate: the dense, moe, ssm (rwkv6) and hybrid (Mamba2) families of the
reference."""
from .model import ModelApi, analytic_param_count, build_model, from_jax_params, param_leaves  # noqa: F401
