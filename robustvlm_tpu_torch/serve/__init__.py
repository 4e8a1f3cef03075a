"""HTTP serving stack: a controller with a worker registry, heartbeats and
dispatch, and model workers; stdlib HTTP only."""
