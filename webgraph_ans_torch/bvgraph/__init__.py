"""Host BvGraph layer: adjacency, BVGraph reader, 3-pass store, random access."""
