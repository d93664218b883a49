"""The OpenAI-compatible HTTP server and the in-process LocalServer."""
