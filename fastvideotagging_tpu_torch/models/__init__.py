"""Models: layers, R(2+1)D, heads, the zoo and the weight bridge."""

from fastvideotagging_tpu_torch.models.zoo import (  # noqa: F401
    get_model,
    list_models,
    model_from_config,
)
