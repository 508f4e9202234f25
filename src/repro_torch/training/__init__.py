"""Training substrate of the port: the AdamW optimizer the router trains with."""
