"""Training data: seeded synthetic clips."""
