"""Serving runtime: page accounting, engine, scheduler, service."""
