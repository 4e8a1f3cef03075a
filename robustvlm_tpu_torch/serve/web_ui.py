"""Browser UI for the serving stack: one self-contained HTML page that the
controller serves on GET / and that drives its JSON endpoints
(/list_models, /worker_generate) from the browser: model picker, image
upload, captioning and VQA.

A copy of `PAGE` in `robustvlm_tpu/serve/web_ui.py`: the port imports
nothing of the JAX package.
"""

PAGE = """<!doctype html>
<html>
<head>
<meta charset="utf-8">
<title>robustvlm_tpu serving</title>
<style>
  body { font-family: system-ui, sans-serif; margin: 2rem auto; max-width: 46rem;
         color: #1a1a2e; }
  h1 { font-size: 1.3rem; }
  fieldset { border: 1px solid #ccd; border-radius: 8px; margin-bottom: 1rem;
             padding: 1rem; }
  label { display: block; margin: .5rem 0 .2rem; font-weight: 600; }
  select, input[type=text], input[type=number] { width: 100%; padding: .4rem;
             box-sizing: border-box; }
  img#preview { max-width: 100%; max-height: 280px; margin-top: .5rem;
             border-radius: 6px; display: none; }
  button { padding: .5rem 1.2rem; border: 0; border-radius: 6px;
           background: #3b5bdb; color: white; font-size: 1rem; cursor: pointer; }
  button:disabled { background: #aab; }
  #answer { white-space: pre-wrap; background: #f1f3f9; border-radius: 6px;
            padding: 1rem; min-height: 2rem; }
  .row { display: flex; gap: 1rem; } .row > div { flex: 1; }
</style>
</head>
<body>
<h1>robustvlm_tpu &mdash; VLM serving</h1>
<fieldset>
  <label for="model">Model</label>
  <select id="model"></select>
  <label for="image">Image</label>
  <input type="file" id="image" accept="image/*">
  <img id="preview">
  <div class="row">
    <div>
      <label for="task">Task</label>
      <select id="task">
        <option value="caption">caption</option>
        <option value="vqa">vqa</option>
      </select>
    </div>
    <div>
      <label for="max_new_tokens">Max new tokens</label>
      <input type="number" id="max_new_tokens" value="32" min="1" max="256">
    </div>
    <div>
      <label for="num_beams">Beams</label>
      <input type="number" id="num_beams" value="3" min="1" max="8">
    </div>
  </div>
  <label for="question">Question (vqa)</label>
  <input type="text" id="question" placeholder="What is in the image?">
  <p><button id="go">Generate</button></p>
</fieldset>
<fieldset><legend>Output</legend><div id="answer"></div></fieldset>
<script>
const $ = (id) => document.getElementById(id);
let imageB64 = null;

async function post(path, body) {
  const r = await fetch(path, {
    method: "POST",
    headers: {"Content-Type": "application/json"},
    body: JSON.stringify(body || {}),
  });
  return r.json();
}

async function loadModels() {
  const res = await post("/list_models");
  const sel = $("model");
  sel.innerHTML = "";
  (res.models || []).forEach((m) => {
    const o = document.createElement("option");
    o.value = o.textContent = m;
    sel.appendChild(o);
  });
  if (!sel.options.length) {
    $("answer").textContent = "no workers registered yet";
  }
}

$("image").addEventListener("change", () => {
  const f = $("image").files[0];
  if (!f) return;
  const rd = new FileReader();
  rd.onload = () => {
    imageB64 = rd.result.split(",", 2)[1];
    $("preview").src = rd.result;
    $("preview").style.display = "block";
  };
  rd.readAsDataURL(f);
});

$("go").addEventListener("click", async () => {
  if (!imageB64) { $("answer").textContent = "pick an image first"; return; }
  $("go").disabled = true;
  $("answer").textContent = "...";
  const body = {
    model: $("model").value,
    image_b64: imageB64,
    task: $("task").value,
    question: $("question").value,
    max_new_tokens: parseInt($("max_new_tokens").value),
    num_beams: parseInt($("num_beams").value),
  };
  try {
    if (body.num_beams <= 1) {
      // greedy: stream tokens as they arrive (NDJSON chunks)
      const r = await fetch("/worker_generate_stream", {
        method: "POST",
        headers: {"Content-Type": "application/json"},
        body: JSON.stringify(body),
      });
      const reader = r.body.getReader();
      const dec = new TextDecoder();
      let buf = "";
      for (;;) {
        const {done, value} = await reader.read();
        if (done) break;
        buf += dec.decode(value, {stream: true});
        const lines = buf.split("\\n");
        buf = lines.pop();
        for (const line of lines) {
          if (!line.trim()) continue;
          const res = JSON.parse(line);
          $("answer").textContent =
            res.error_code === 0 ? res.text : JSON.stringify(res);
        }
      }
    } else {
      const res = await post("/worker_generate", body);
      $("answer").textContent =
        res.error_code === 0 ? res.text : JSON.stringify(res);
    }
  } catch (e) {
    $("answer").textContent = String(e);
  } finally {
    $("go").disabled = false;
  }
});

loadModels();
</script>
</body>
</html>
"""
