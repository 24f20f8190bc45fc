"""Layer primitives (norms, MLPs, rope, embeddings), GQA attention and the
MoE layer with its BinomialHash router."""
