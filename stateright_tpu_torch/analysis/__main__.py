import sys

from .cli import main

if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # e.g. `... --list-rules | head`
        sys.exit(0)
