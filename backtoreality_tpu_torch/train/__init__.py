"""Entry points of the port: evaluation and VoteNet FSB training."""
