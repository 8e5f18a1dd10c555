"""FUnc-SNE core of the port: counter-RNG KNN primitives, affinities, the
step and its chunk runner, quality metrics and the state bridge."""
