"""Command-line option parsing (copy of
`kaldi_tpu/util/parse_options.py`; the reference's
util/parse-options.h:36): GNU-style `--option=value` flags
registered from options dataclasses, positional arguments, `--config=file`
indirection, `--print-args`, `--help`, `--verbose`. Boolean flags accept
`--flag`, `--flag=true/false`. Options structs register under optional
name prefixes (`--mfcc-config` style prefixing).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, fields, is_dataclass
from typing import Any, Dict, List, Optional

from kaldi_tpu_torch.base.logging import KaldiTpuError, set_verbose_level


def _parse_bool(s: str) -> bool:
    if s.lower() in ("true", "t", "1", ""):
        return True
    if s.lower() in ("false", "f", "0"):
        return False
    raise KaldiTpuError(f"invalid boolean value {s!r}")


class ParseOptions:
    def __init__(self, usage: str):
        self.usage = usage
        # name -> (getter, setter, type, doc)
        self._opts: Dict[str, tuple] = {}
        self.positional: List[str] = []
        self.print_args = True
        self.register("print-args", bool, "Print the command line arguments (to stderr)",
                      lambda: self.print_args, self._set_print_args)
        self._verbose = 0
        self.register("verbose", int, "Verbose level (higher->more logging)",
                      lambda: self._verbose, self._set_verbose)

    def _set_print_args(self, v):
        self.print_args = v

    def _set_verbose(self, v):
        self._verbose = v
        set_verbose_level(v)

    def register(self, name: str, typ, doc: str, getter, setter) -> None:
        name = name.replace("_", "-")
        self._opts[name] = (getter, setter, typ, doc)

    def register_value(self, name: str, default, doc: str):
        """Register a standalone option; retrieve with .get(name)."""
        box = [default]
        self.register(name, type(default), doc, lambda: box[0],
                      lambda v: box.__setitem__(0, v))
        return box

    def register_struct(self, opts_obj, prefix: str = "") -> None:
        """Register every field of an options dataclass. Field metadata
        key 'doc' supplies help text; names map snake_case -> kebab-case."""
        if not is_dataclass(opts_obj):
            raise KaldiTpuError("register_struct requires a dataclass")
        for f in fields(opts_obj):
            if is_dataclass(getattr(opts_obj, f.name)):
                sub_prefix = f.metadata.get("prefix", "")
                self.register_struct(getattr(opts_obj, f.name),
                                     prefix=prefix or sub_prefix)
                continue
            name = f.metadata.get("name", f.name.replace("_", "-"))
            if prefix:
                name = f"{prefix}.{name}"
            doc = f.metadata.get("doc", "")
            def make_setter(obj, fname, ftype):
                def setter(v):
                    setattr(obj, fname, v)
                return setter
            self.register(name, f.type if isinstance(f.type, type) else type(getattr(opts_obj, f.name)),
                          doc, (lambda obj=opts_obj, fn=f.name: getattr(obj, fn)),
                          make_setter(opts_obj, f.name, f.type))

    def _set(self, name: str, str_value: str) -> None:
        if name not in self._opts:
            raise KaldiTpuError(f"unknown option --{name}")
        getter, setter, typ, _ = self._opts[name]
        cur = getter()
        if typ is bool or isinstance(cur, bool):
            setter(_parse_bool(str_value))
        elif typ is int or isinstance(cur, int):
            setter(int(str_value))
        elif typ is float or isinstance(cur, float):
            setter(float(str_value))
        else:
            setter(str_value)

    def read(self, argv: List[str]) -> "ParseOptions":
        """Parse argv (sys.argv style: argv[0] = program name)."""
        self.program = argv[0] if argv else ""
        args = argv[1:]
        i = 0
        double_dash = False
        while i < len(args):
            a = args[i]
            if a == "--":
                double_dash = True
                i += 1
                continue
            if a.startswith("--") and not double_dash:
                body = a[2:]
                if "=" in body:
                    name, value = body.split("=", 1)
                else:
                    name, value = body, ""
                name = name.replace("_", "-")
                if name == "help":
                    self.print_usage()
                    sys.exit(0)
                if name == "config":
                    self._read_config(value)
                else:
                    self._set(name, value)
            else:
                self.positional.append(a)
            i += 1
        if self.print_args:
            print(" ".join(argv), file=sys.stderr)
        return self

    def _read_config(self, path: str) -> None:
        with open(path) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                if not line.startswith("--"):
                    raise KaldiTpuError(f"bad config line {line!r} in {path}")
                body = line[2:]
                name, _, value = body.partition("=")
                self._set(name.replace("_", "-"), value)

    def num_args(self) -> int:
        return len(self.positional)

    def get_arg(self, i: int) -> str:
        """1-based positional access, like the reference."""
        if i < 1 or i > len(self.positional):
            raise KaldiTpuError(f"missing positional argument {i}")
        return self.positional[i - 1]

    def get_opt_arg(self, i: int, default: str = "") -> str:
        return self.positional[i - 1] if i <= len(self.positional) else default

    def get(self, name: str):
        return self._opts[name.replace("_", "-")][0]()

    def print_usage(self) -> None:
        print(self.usage, file=sys.stderr)
        print("\nOptions:", file=sys.stderr)
        for name in sorted(self._opts):
            getter, _, typ, doc = self._opts[name]
            tname = getattr(typ, "__name__", str(typ))
            print(f"  --{name:<30} : {doc} ({tname}, default = {getter()})",
                  file=sys.stderr)
