"""Static HTML gallery writer (reference util/html.py).

The reference uses the `dominate` library; this is a dependency-free
writer with the same API surface (add_header / add_images / save) and the
same output layout: {web_dir}/index.html + {web_dir}/images/*.
"""

from __future__ import annotations

import html as _html
import os


class HTML:
    def __init__(self, web_dir: str, title: str, refresh: int = 0):
        self.title = title
        self.web_dir = web_dir
        self.img_dir = os.path.join(self.web_dir, "images")
        os.makedirs(self.img_dir, exist_ok=True)
        self.refresh = refresh
        self._body: list[str] = []

    def get_image_dir(self) -> str:
        return self.img_dir

    def add_header(self, text: str):
        self._body.append(f"<h3>{_html.escape(str(text))}</h3>")

    def add_images(self, ims, txts, links, width: int = 400):
        cells = []
        for im, txt, link in zip(ims, txts, links):
            cells.append(
                "<td style='word-wrap:break-word;' halign='center' valign='top'>"
                f"<p><a href='images/{link}'>"
                f"<img style='width:{width}px' src='images/{im}'></a><br>"
                f"{_html.escape(str(txt))}</p></td>"
            )
        self._body.append(
            "<table border='1' style='table-layout:fixed;'><tr>"
            + "".join(cells)
            + "</tr></table>"
        )

    def save(self):
        refresh = (
            f"<meta http-equiv='refresh' content='{self.refresh}'>"
            if self.refresh > 0
            else ""
        )
        doc = (
            "<!DOCTYPE html><html><head>"
            f"<title>{_html.escape(self.title)}</title>{refresh}</head><body>"
            + "\n".join(self._body)
            + "</body></html>"
        )
        with open(os.path.join(self.web_dir, "index.html"), "w") as f:
            f.write(doc)
