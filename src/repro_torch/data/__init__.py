"""Data pipeline: seeded synthetic token streams packed into fixed-length batches."""
