"""``python -m repro_torch.tuning warm|show|clear`` (``cli.main``)."""
import signal

from repro_torch.tuning.cli import main

if __name__ == "__main__":
    # Die silently on a closed pipe (`... | head`) like standard unix tools.
    try:
        signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    except (AttributeError, ValueError):  # pragma: no cover - non-posix
        pass
    raise SystemExit(main())
