"""Layers of the port (twin of ``repro.layers``): norms, MLP, embedding,
rotary embeddings, GQA attention and the Mamba2 SSM block."""
