"""The card's name and power limit, as ``nvidia-smi`` reports them."""

import subprocess


def card_line() -> str:
    """``"<name>, <power limit>"`` of the first card, or ``""`` where
    ``nvidia-smi`` is missing or prints nothing."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return ""
    return out[0].strip() if out else ""
