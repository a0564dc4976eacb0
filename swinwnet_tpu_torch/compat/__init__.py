from .torch_import import load_pth, sniff_error_matrix, state_dict_from_jax, unwrap_state_dict

__all__ = ["load_pth", "sniff_error_matrix", "state_dict_from_jax", "unwrap_state_dict"]
