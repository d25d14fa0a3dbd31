"""Dispatcher: `python -m kaldi_tpu_torch.cli <tool> [args...]`."""

import sys

from kaldi_tpu_torch.cli import TOOLS, get_tool


def main() -> int:
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help", "help"):
        print("usage: python -m kaldi_tpu_torch.cli <tool> [args...]\n\n"
              "tools:", file=sys.stderr)
        for name in sorted(TOOLS):
            print(f"  {name}", file=sys.stderr)
        return 1
    name = sys.argv[1]
    if name not in TOOLS:
        print(f"unknown tool {name!r}", file=sys.stderr)
        return 1
    try:
        return get_tool(name)([name] + sys.argv[2:])
    except KeyboardInterrupt:
        return 130
    except BrokenPipeError:
        return 141
    except Exception as e:  # noqa: BLE001 -- a Kaldi-style clean exit
        print(f"ERROR ({name}): {type(e).__name__}: {e}", file=sys.stderr)
        return 255


if __name__ == "__main__":
    sys.exit(main())
