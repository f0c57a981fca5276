"""Layers of the port (twin of ``repro.layers``): norms, MLP, embedding,
rotary embeddings and GQA attention."""
