"""SM-tree engine of the PyTorch port: metric, split, tree, queries, engine."""
