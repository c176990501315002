"""A minimal DOM over the stdlib ``html.parser``: what the scrapers need
of xpath (elements by tag and attribute, text, children), as
``fmda_tpu.ingest.htmldom`` builds it, with no dependency."""

from __future__ import annotations

from dataclasses import dataclass, field
from html.parser import HTMLParser
from typing import Dict, Iterator, List, Optional

_VOID_TAGS = {
    "area", "base", "br", "col", "embed", "hr", "img", "input",
    "link", "meta", "param", "source", "track", "wbr",
}


@dataclass
class Element:
    tag: str
    attrs: Dict[str, str] = field(default_factory=dict)
    children: List["Element"] = field(default_factory=list)
    texts: List[str] = field(default_factory=list)
    parent: Optional["Element"] = None

    def iter(self) -> Iterator["Element"]:
        yield self
        for child in self.children:
            yield from child.iter()

    def find_all(self, tag: str, **attrs: str) -> List["Element"]:
        """All descendants with this tag whose attributes contain the given
        values (class matching is token-wise, like CSS)."""
        out = []
        for el in self.iter():
            if el is self or el.tag != tag:
                continue
            ok = True
            for key, want in attrs.items():
                key = key.rstrip("_")  # allow class_=
                have = el.attrs.get(key)
                if have is None:
                    ok = False
                elif key == "class":
                    if want not in have.split() and want != have:
                        ok = False
                elif want not in have:
                    ok = False
            if ok:
                out.append(el)
        return out

    def find(self, tag: str, **attrs: str) -> Optional["Element"]:
        found = self.find_all(tag, **attrs)
        return found[0] if found else None

    @property
    def text(self) -> str:
        """All descendant text, concatenated (xpath ``string()``)."""
        parts = list(self.texts)
        for child in self.children:
            parts.append(child.text)
        return "".join(parts)

    @property
    def own_text(self) -> str:
        """Direct text nodes only (xpath ``text()``)."""
        return "".join(self.texts)


class _TreeBuilder(HTMLParser):
    def __init__(self) -> None:
        super().__init__(convert_charrefs=True)
        self.root = Element("__root__")
        self._stack = [self.root]

    def handle_starttag(self, tag, attrs):
        el = Element(tag, dict(attrs), parent=self._stack[-1])
        self._stack[-1].children.append(el)
        if tag not in _VOID_TAGS:
            self._stack.append(el)

    def handle_startendtag(self, tag, attrs):
        el = Element(tag, dict(attrs), parent=self._stack[-1])
        self._stack[-1].children.append(el)

    def handle_endtag(self, tag):
        # close the nearest matching open tag (tolerates sloppy HTML)
        for i in range(len(self._stack) - 1, 0, -1):
            if self._stack[i].tag == tag:
                del self._stack[i:]
                break

    def handle_data(self, data):
        if data:
            self._stack[-1].texts.append(data)


def parse_html(html: str) -> Element:
    builder = _TreeBuilder()
    builder.feed(html if isinstance(html, str) else html.decode("utf-8", "replace"))
    return builder.root
