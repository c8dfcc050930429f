"""Partition primitives for sharded NetworkPlan execution (`sharding`)."""
