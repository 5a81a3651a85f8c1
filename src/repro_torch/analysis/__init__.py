"""Shape-level cost accounting of the port's chains."""
