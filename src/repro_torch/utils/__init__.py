from repro_torch.utils.convert import tree_from_numpy, tree_to_numpy
from repro_torch.utils.humanize import fmt_bw, fmt_bytes, fmt_dur
from repro_torch.utils.treelib import flatten_with_names, tree_leaves, tree_map, unflatten

__all__ = [
    "fmt_bytes",
    "fmt_dur",
    "fmt_bw",
    "flatten_with_names",
    "tree_from_numpy",
    "tree_leaves",
    "tree_map",
    "tree_to_numpy",
    "unflatten",
]
