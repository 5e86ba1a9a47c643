"""OpenAI-compatible serving front end for the port's engine."""
