// Stateright Explorer — original single-page app.
//
// Speaks the Explorer HTTP contract (see stateright_tpu_torch/checker/explorer.py):
//   GET  /.status               -> {done, model, state_count, unique_state_count,
//                                   max_depth, properties, recent_path}
//   GET  /.states/<fp>/<fp>/... -> [{action?, outcome?, state?, fingerprint?,
//                                   properties, svg?}, ...]
//   POST /.runtocompletion
// Properties are [expectation, name, encodedDiscoveryPathOrNull] triples with
// expectation one of "Always" | "Sometimes" | "Eventually".
//
// Routing: #/steps/<fp>/<fp>...?offset=<n> — the fingerprint path of the
// states walked so far, plus the selected row.

"use strict";

const stateCache = new Map(); // fp-path string -> states JSON

async function fetchStates(fpPath) {
  if (stateCache.has(fpPath)) return stateCache.get(fpPath);
  const res = await fetch("/.states" + (fpPath ? "/" + fpPath : "/"));
  if (!res.ok) throw new Error(await res.text());
  const states = await res.json();
  stateCache.set(fpPath, states);
  return states;
}

function propertyIcon(p, pathWithLeadingSlash) {
  // Mirror of the reference UI's per-state iconography: at the discovery
  // state show the verdict, before it show "deeper", after it show "above".
  const [expectation, _name, discoveryPath] = p;
  if (discoveryPath) {
    // Prefix tests honor "/" segment boundaries so fingerprint "12" is not
    // treated as an ancestor of "123/...".
    const dp = "/" + discoveryPath;
    const ancestorOfDiscovery = dp === pathWithLeadingSlash || dp.startsWith(pathWithLeadingSlash + "/");
    const descendantOfDiscovery = pathWithLeadingSlash.startsWith(dp + "/");
    if (ancestorOfDiscovery || descendantOfDiscovery) {
      if (dp.length > pathWithLeadingSlash.length) return "⬇️";
      if (dp.length < pathWithLeadingSlash.length) return "⬆️";
      return expectation === "Sometimes" ? "✅" : "⚠️";
    }
    return expectation === "Sometimes" ? "✅" : "⚠️";
  }
  return expectation === "Sometimes" ? "⚠️" : "✅";
}

function propertySummary(p, done) {
  const [expectation, name, discoveryPath] = p;
  let text;
  if (discoveryPath) {
    text = expectation === "Sometimes" ? "✅ example found" : "⚠️ counterexample found";
  } else if (!done) {
    text = "🔎 searching";
  } else {
    text =
      expectation === "Sometimes" ? "⚠️ example not found"
      : expectation === "Always" ? "✅ safety holds"
      : "✅ liveness holds";
  }
  return `${text}: ${expectation} “${name}”`;
}

// --- routing ---------------------------------------------------------------

function parseHash() {
  const h = location.hash || "#/steps";
  const m = h.match(/^#\/steps\/?([^?]*)(?:\?offset=(\d+))?$/);
  if (!m) return { fps: [], offset: 0 };
  const fps = m[1] ? m[1].split("/").filter((s) => s.length) : [];
  return { fps, offset: m[2] ? parseInt(m[2], 10) : 0 };
}

function navigate(fps, offset) {
  const path = fps.length ? "/" + fps.join("/") : "";
  location.hash = `#/steps${path}${offset ? "?offset=" + offset : ""}`;
}

// --- rendering -------------------------------------------------------------

const el = (id) => document.getElementById(id);

let current = { fps: [], offset: 0, steps: [] };

async function render() {
  const { fps, offset } = parseHash();
  const fpPath = fps.join("/");
  let steps;
  try {
    steps = await fetchStates(fpPath);
  } catch (err) {
    el("steps").innerHTML = `<div class="empty">${escapeHtml(err.message)}</div>`;
    return;
  }
  // A slow fetch may resolve after the user navigated away; the newer
  // render owns the DOM.
  const now = parseHash();
  if (now.fps.join("/") !== fpPath || now.offset !== offset) return;
  current = { fps, offset, steps };

  // Breadcrumbs: root plus one crumb per walked fingerprint.
  const crumbs = [`<a href="#/steps">init</a>`];
  for (let i = 0; i < fps.length; i++) {
    const prefix = fps.slice(0, i + 1).join("/");
    crumbs.push(`<a href="#/steps/${prefix}">${fps[i]}</a>`);
  }
  el("breadcrumbs").innerHTML = crumbs.join('<span class="sep">/</span>');

  // Step list.
  const stepsEl = el("steps");
  stepsEl.innerHTML = "";
  if (!steps.length) {
    stepsEl.innerHTML = '<div class="empty">No next steps — terminal state.</div>';
  }
  steps.forEach((s, i) => {
    const div = document.createElement("div");
    const ignored = !("fingerprint" in s);
    div.className = "step" + (ignored ? " ignored" : "") + (i === offset ? " selected" : "");
    const childPath = "/" + fps.concat(s.fingerprint || []).join("/");
    const icons = ignored
      ? ""
      : (s.properties || []).map((p) => propertyIcon(p, childPath)).join(" ");
    div.innerHTML =
      `<span class="icons">${icons}</span>` +
      `<div class="action">${s.action ? escapeHtml(s.action) : "init state " + i}</div>` +
      (ignored
        ? '<div class="outcome">action ignored (no-op)</div>'
        : `<div class="outcome">${escapeHtml(s.outcome || s.state || "")}</div>` +
          `<div class="fp">fp ${s.fingerprint}</div>`);
    if (!ignored) {
      div.addEventListener("click", () => {
        if (i === offset) descend();
        else navigate(fps, i);
      });
    }
    stepsEl.appendChild(div);
  });

  // Detail pane for the selected step.
  const sel = steps[offset];
  el("state-detail").textContent = sel && sel.state ? sel.state : "";
  el("svg-pane").innerHTML = sel && sel.svg ? sel.svg : "";
}

function escapeHtml(s) {
  return String(s).replace(/[&<>"']/g, (c) => ({
    "&": "&amp;", "<": "&lt;", ">": "&gt;", '"': "&quot;", "'": "&#39;",
  })[c]);
}

function descend() {
  const { fps, offset, steps } = current;
  const sel = steps[offset];
  if (sel && sel.fingerprint) navigate(fps.concat(sel.fingerprint), 0);
}

function ascend() {
  const { fps } = current;
  if (fps.length) navigate(fps.slice(0, -1), 0);
}

function move(delta) {
  const { fps, offset, steps } = current;
  if (!steps.length) return;
  const next = Math.min(Math.max(offset + delta, 0), steps.length - 1);
  if (next !== offset) navigate(fps, next);
}

// --- status pane -----------------------------------------------------------

async function pollStatus() {
  try {
    const res = await fetch("/.status");
    if (!res.ok) return;
    const s = await res.json();
    el("model-name").textContent = s.model;
    el("done-indicator").textContent = s.done ? "✅ done" : "🔎 searching";
    el("state-count").textContent = s.state_count.toLocaleString();
    el("unique-count").textContent = s.unique_state_count.toLocaleString();
    el("max-depth").textContent = s.max_depth;
    el("run-to-completion").disabled = s.done;
    const list = el("property-list");
    list.innerHTML = "";
    for (const p of s.properties) {
      const li = document.createElement("li");
      li.textContent = propertySummary(p, s.done);
      if (p[2]) {
        const a = document.createElement("a");
        a.href = "#/steps/" + p[2];
        a.textContent = " ↪ view path";
        li.appendChild(a);
      }
      list.appendChild(li);
    }
    el("recent-path").textContent = s.recent_path || "";
    // Discoveries and counts can change which icons apply; drop the cache
    // when the run finishes so the next render reflects final verdicts.
    if (s.done && !pollStatus._wasDone) {
      stateCache.clear();
      render();
    }
    pollStatus._wasDone = s.done;
  } catch (_err) {
    /* server restarting; keep polling */
  }
}

// --- wiring ----------------------------------------------------------------

window.addEventListener("hashchange", render);
window.addEventListener("keydown", (e) => {
  if (e.key === "j" || e.key === "ArrowDown") { move(1); e.preventDefault(); }
  else if (e.key === "k" || e.key === "ArrowUp") { move(-1); e.preventDefault(); }
  else if (e.key === "Enter" || e.key === "ArrowRight") { descend(); e.preventDefault(); }
  else if (e.key === "ArrowLeft" || e.key === "h") { ascend(); e.preventDefault(); }
});
el("run-to-completion").addEventListener("click", async () => {
  await fetch("/.runtocompletion", { method: "POST" });
});

render();
pollStatus();
setInterval(pollStatus, 5000);
