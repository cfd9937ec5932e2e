from repro_torch.common.tree import tree_bytes, tree_cast, tree_count
