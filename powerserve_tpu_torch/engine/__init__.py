"""Generation engine and bench loops."""
