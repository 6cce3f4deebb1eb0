from .messages import Certificate, Header, Vote, genesis

__all__ = ["Certificate", "Header", "Vote", "genesis"]
