"""Cook-Toom transforms, tiling geometry, the executor registry, per-layer
plans and the graph compiler."""
