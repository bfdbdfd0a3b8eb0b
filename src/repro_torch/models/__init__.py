"""The llama-family model of the port (dense causal GQA transformer)."""
