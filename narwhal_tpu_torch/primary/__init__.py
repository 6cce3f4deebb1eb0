from .messages import Certificate, Header, Vote, genesis
from .primary import Primary

__all__ = ["Certificate", "Header", "Vote", "genesis", "Primary"]
