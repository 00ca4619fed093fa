"""Kernel K5, the embedding-bag lookup: ``embedding_bag`` (CUDA wrapper),
``embedding_bag_ref`` (plain torch) and ``bag_lookup`` (differentiable)."""
