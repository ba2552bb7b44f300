"""Model configs and the decoder forward passes."""
