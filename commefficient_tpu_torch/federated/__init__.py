"""Client, server, round engine, accounting and the FedModel API."""
