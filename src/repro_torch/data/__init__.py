"""The deterministic token pipeline and the coreset selector."""
