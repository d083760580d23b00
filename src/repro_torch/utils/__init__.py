from repro_torch.utils.convert import tree_from_numpy, tree_to_numpy
from repro_torch.utils.treelib import flatten_with_names, tree_leaves, tree_map, unflatten

__all__ = [
    "flatten_with_names",
    "tree_from_numpy",
    "tree_leaves",
    "tree_map",
    "tree_to_numpy",
    "unflatten",
]
