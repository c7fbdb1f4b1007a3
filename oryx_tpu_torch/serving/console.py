"""Per-app HTML console served at the context root.

Counterpart of ``oryx_tpu/serving/console.py``, whole: the page is the
reference's byte for byte, so both packages serve the same console.

Reference capability: each serving app ships a small interactive
console page (app/oryx-app-serving/.../AbstractConsoleResource.java:35
wrapping an app fragment in a shared header/footer, served as
text/html with X-Frame-Options).  This is a fresh single-page
implementation: one template, endpoint descriptors per app, fetch()-
based query execution with the raw JSON response shown inline.
"""

from __future__ import annotations

import json

from ..lambda_rt.http import HtmlResponse, Request, Route

__all__ = ["console_route", "Endpoint"]


class Endpoint:
    """One console row: endpoint path template + input field names.

    ``path`` uses ``{0}``, ``{1}``… placeholders filled from the field
    values; ``query`` lists optional query parameters offered as a
    free-text suffix box.
    """

    def __init__(self, path: str, fields: tuple[str, ...] = (),
                 method: str = "GET", note: str = ""):
        self.path = path
        self.fields = fields
        self.method = method
        self.note = note

    def spec(self) -> dict:
        return {"path": self.path, "fields": list(self.fields),
                "method": self.method, "note": self.note}


_PAGE = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8"/>
<title>{title} — oryx-tpu serving console</title>
<style>
  body {{ font-family: system-ui, sans-serif; margin: 2rem auto;
         max-width: 60rem; color: #1a2733; }}
  h1 {{ font-size: 1.3rem; }} h1 small {{ color: #7a8793; font-weight: normal; }}
  table {{ border-collapse: collapse; width: 100%; }}
  td {{ padding: .35rem .5rem; border-bottom: 1px solid #e4e9ee; }}
  code {{ color: #0b5394; }}
  input {{ border: 1px solid #b8c2cc; border-radius: 3px; padding: .2rem .4rem; }}
  button {{ border: 1px solid #0b5394; background: #0b5394; color: white;
           border-radius: 3px; padding: .2rem .7rem; cursor: pointer; }}
  pre {{ background: #f4f7fa; border: 1px solid #e4e9ee; border-radius: 4px;
        padding: .8rem; white-space: pre-wrap; word-break: break-all;
        min-height: 3rem; }}
  .status {{ color: #7a8793; font-size: .85rem; }}
</style>
</head>
<body>
<h1>{title} <small>serving console</small></h1>
<table id="endpoints"></table>
<h2 style="font-size:1rem">Response <span class="status" id="status"></span></h2>
<pre id="out">(run a query)</pre>
<script>
const ENDPOINTS = {endpoints_json};
const table = document.getElementById("endpoints");
ENDPOINTS.forEach((ep, i) => {{
  const row = table.insertRow();
  row.insertCell().innerHTML = "<code>" + ep.method + " " + ep.path + "</code>";
  const cell = row.insertCell();
  ep.fields.forEach((f, j) => {{
    cell.innerHTML += '<input size="10" placeholder="' + f +
        '" id="f' + i + '_' + j + '"/> ';
  }});
  cell.innerHTML += '<input size="14" placeholder="query string" id="q' +
      i + '"/>';
  const go = row.insertCell();
  go.innerHTML = '<button onclick="run(' + i + ')">run</button>';
  if (ep.note) row.insertCell().textContent = ep.note;
}});
async function run(i) {{
  const ep = ENDPOINTS[i];
  let path = ep.path;
  ep.fields.forEach((f, j) => {{
    path = path.replace("{{" + j + "}}",
        encodeURIComponent(document.getElementById("f" + i + "_" + j).value));
  }});
  const q = document.getElementById("q" + i).value;
  if (q) path += "?" + q;
  const status = document.getElementById("status");
  status.textContent = "…";
  try {{
    const resp = await fetch(path, {{method: ep.method}});
    status.textContent = resp.status + " " + resp.statusText;
    const text = await resp.text();
    try {{ document.getElementById("out").textContent =
        JSON.stringify(JSON.parse(text), null, 2); }}
    catch (e) {{ document.getElementById("out").textContent = text; }}
  }} catch (e) {{
    status.textContent = "error";
    document.getElementById("out").textContent = String(e);
  }}
}}
</script>
</body>
</html>
"""


def console_route(title: str, endpoints: list[Endpoint]) -> Route:
    """The app's ``GET /`` console page (reference:
    AbstractConsoleResource serving index.html per app)."""
    page = _PAGE.format(
        title=title,
        endpoints_json=json.dumps([e.spec() for e in endpoints]))

    def _console(req: Request):
        return HtmlResponse(page)

    return Route("GET", "/", _console)
