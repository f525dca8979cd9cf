"""Model families: how the benchmark builds each model from the seed,
draws its traffic, calls the port, and reads its plain reference."""
