from .torch_import import (
    jax_tree_from_state_dict,
    load_pth,
    sniff_error_matrix,
    state_dict_from_jax,
    unwrap_state_dict,
)

__all__ = ["jax_tree_from_state_dict", "load_pth", "sniff_error_matrix", "state_dict_from_jax",
           "unwrap_state_dict"]
