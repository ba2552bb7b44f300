"""Ollama-compatible HTTP surface and prompt templates."""
