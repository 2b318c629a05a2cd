"""Model substrate: the dense, moe, ssm (rwkv6), hybrid (Mamba2), encdec
(whisper) and vlm (phi-3-vision) families of the reference."""
from .model import (ModelApi, analytic_param_count, batch_shapes, build_model,  # noqa: F401
                    from_jax_params, make_batch, param_leaves)
